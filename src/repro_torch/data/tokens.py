"""Synthetic LM token streams, deterministic and host-shardable: a copy of
``repro/data/tokens.py`` (numpy's Philox, so the port draws the reference's
batches bit for bit without importing the JAX package)."""
from __future__ import annotations

import numpy as np


def token_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                *, host_id: int = 0, n_hosts: int = 1) -> dict:
    """Markov-ish synthetic tokens, deterministic in (seed, step, row):
    ``tokens`` and ``labels`` (the tokens shifted by one), int32 (B, S).

    Each host materializes only its batch shard (rows
    ``host_id * batch//n_hosts : (host_id+1) * batch//n_hosts``).
    """
    assert batch % n_hosts == 0
    local = batch // n_hosts
    rows = np.arange(host_id * local, (host_id + 1) * local, dtype=np.uint64)
    out = np.empty((local, seq_len + 1), np.int32)
    for i, row in enumerate(rows):
        # per-row independent streams via the Philox counter
        r = np.random.Generator(np.random.Philox(key=seed,
                                                 counter=[step, row, 0, 0]))
        base = r.integers(0, vocab, size=seq_len + 1, dtype=np.int64)
        # induce local structure (learnable bigram-ish patterns)
        rep = r.integers(2, 8)
        base[rep::rep] = base[:-rep:rep]
        out[i] = (base % vocab).astype(np.int32)
    return {"tokens": out[:, :-1], "labels": out[:, 1:]}
