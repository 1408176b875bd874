"""Batched decode engine: a continuous-batching request loop (counterpart of
``repro/serve/engine.py``).

Slots hold independent requests.  A request is prefilled alone (batch 1)
and its cache copied into a free slot; then one batched decode step per
iteration advances every slot, with greedy ``argmax`` sampling.  Finished
sequences (EOS or length budget) free their slot for the next queued
request between steps; cache writes are at per-sequence lengths, so slots
are reused in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.layers import Policy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new_tokens: int = 16
    generated: Optional[list] = None


class DecodeEngine:
    """``model`` is the family's module (``models.get_model(cfg)``) and
    ``params`` its parameters, cast to bf16 once here (the reference casts
    at every prefill and decode step; the cast is deterministic, so the
    numbers are the same) and placed on ``device`` (``cuda`` by default,
    raising without a card unless ``device="cpu"``).

    ``last_stats`` of a ``run``: per request its prompt length, prefill
    seconds and the time from the run's start to its first token; per decode
    step its seconds and the tokens it produced.  Each time ends in a device
    synchronisation (the sampled tokens are read on the host)."""

    def __init__(self, model, cfg, params, *, batch_slots: int,
                 max_len: int, eos_id: int = -1, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.params = Policy().cast(params).to(self.device)
        self.batch = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = model.init_cache(cfg, batch_slots, max_len,
                                      device=self.device)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.budget = np.zeros(batch_slots, np.int32)
        self.cur = np.zeros(batch_slots, np.int32)   # last sampled token
        self.last_stats: dict = {}

    def _insert(self, slot: int, req: Request):
        t0 = time.perf_counter()
        cache1 = self.model.init_cache(self.cfg, 1, self.max_len,
                                       device=self.device)
        prompt = torch.as_tensor(np.asarray(req.prompt),
                                 device=self.device)[None, :]
        logits, cache1 = self.model.prefill(self.params, self.cfg, prompt,
                                            cache1)
        # copy the batch-1 cache into this slot
        for key, dst in self.cache.items():
            if key == "length":
                dst[slot] = cache1[key][0]
            else:
                dst[:, slot] = cache1[key][:, 0]
        req.generated = []
        self.slots[slot] = req
        # the prefill's last logits already give generated token #1
        self.budget[slot] = req.max_new_tokens - 1
        self.cur[slot] = int(torch.argmax(logits[0, -1]))
        req.generated.append(int(self.cur[slot]))
        t1 = time.perf_counter()
        self.last_stats["prefill"].append(dict(
            rid=req.rid, prompt_len=int(prompt.shape[1]), seconds=t1 - t0,
            first_token_s=t1 - self._t_run))

    @torch.no_grad()
    def run(self, requests: list[Request], *, greedy: bool = True) -> dict:
        """Serve ``requests`` to the end; returns {rid: generated token ids}.
        Sampling is greedy whatever ``greedy`` says, as in the reference,
        which takes the keyword and ignores it."""
        self._t_run = time.perf_counter()
        self.last_stats = {"prefill": [], "decode_step_s": [],
                           "decode_tokens": []}
        queue = list(requests)
        done: dict[int, list[int]] = {}
        while queue or any(s is not None for s in self.slots):
            # fill empty slots
            for i in range(self.batch):
                if self.slots[i] is None and queue:
                    self._insert(i, queue.pop(0))
            # finalise requests satisfied by prefill alone (or EOS)
            for i in range(self.batch):
                req = self.slots[i]
                if req is not None and (self.budget[i] <= 0 or
                                        self.cur[i] == self.eos_id):
                    done[req.rid] = req.generated
                    self.slots[i] = None
            if not any(s is not None for s in self.slots):
                continue
            # one batched decode step
            t0 = time.perf_counter()
            tokens = torch.as_tensor(self.cur, device=self.device)[:, None]
            logits, self.cache = self.model.decode_step(
                self.params, self.cfg, tokens, self.cache)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            self.last_stats["decode_step_s"].append(time.perf_counter() - t0)
            produced = 0
            for i in range(self.batch):
                req = self.slots[i]
                if req is None:
                    continue
                tok = int(nxt[i])
                req.generated.append(tok)
                produced += 1
                self.budget[i] -= 1
                self.cur[i] = tok
                if tok == self.eos_id or self.budget[i] <= 0:
                    done[req.rid] = req.generated
                    self.slots[i] = None
            self.last_stats["decode_tokens"].append(produced)
        self.last_stats["wall_s"] = time.perf_counter() - self._t_run
        return done
