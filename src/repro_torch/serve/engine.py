"""Batched decode engine: a continuous-batching request loop (counterpart of
``repro/serve/engine.py``).

Slots hold independent requests.  A request is prefilled alone (batch 1)
and its cache copied into a free slot; then one batched decode step per
iteration advances every slot, with greedy ``argmax`` sampling.  Finished
sequences (EOS or length budget) free their slot for the next queued
request between steps; cache writes are at per-sequence lengths, so slots
are reused in place.

As the reference jit-compiles ``_decode`` once and ``_prefill1`` once per
prompt length, the engine builds these steps once and caches them
(``compile_misses`` counts the builds); on the card each is a CUDA graph,
captured at its first call (``graphs=``).  Every tensor a step touches is
static: the slot cache and the batch-1 prefill cache are allocated once and
written in place, never rebound.

On a rank of a ("data", "model") mesh (``mesh=``) the engine is
tensor-parallel: ``params`` are the rank's slices (``serve.steps
.serve_layout``), the steps run under ``parallel.tensor.model_parallel``,
the caches are the rank's (``serve.steps.init_local_cache``): the slots'
rows split over 'data' where it divides them, the KV heads as the cache
rules say.  Every rank runs the same host loop over every slot; a prefill
(batch 1) runs on every rank, and only the ranks that hold its slot keep
its cache; a decode step runs on the rank's rows, its greedy tokens taken
over the vocabulary's split (``tensor.greedy``) and gathered over the
batch's axes.  Under ``cfg.factored_decode`` with narrow GQA the decode
step runs on the factored mesh (``serve.steps.decode_mesh_plan``: 'model'
as (kvh, brep)): the slots' rows split over ('data', 'brep'), the KV heads
over 'kvh', and the step gathers the weight slices over 'brep' before it
computes on 'kvh', as GSPMD does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import graphs as graphs_lib
from repro_torch.device import resolve_device
from repro_torch.nn.layers import Policy
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import tensor
from repro_torch.parallel.mesh_utils import Axis, mesh_shape


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
    synchronisation (the sampled tokens are read on the host).

    ``graphs``: run ``_decode`` and each prompt length's ``_prefill1`` as
    CUDA graphs (``graphs.CapturedStep``, all in one memory pool); None
    means on for a CUDA device and off on the CPU, True on the CPU raises
    ValueError.  ``compile_misses``: the steps built, the decode step's at
    construction and one prefill step per distinct prompt length."""

    def __init__(self, model, cfg, params, *, batch_slots: int,
                 max_len: int, eos_id: int = -1, device=None,
                 graphs: Optional[bool] = None, mesh=None):
        self.device = resolve_device(device)
        backend = None
        if mesh is not None:
            import torch.distributed as dist
            backend = dist.get_backend()
        self.graphs = graphs_lib.use_graphs(graphs, self.device, backend)
        self.model, self.cfg = model, cfg
        self.params = Policy().cast(params).to(self.device)
        self.batch = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self._mesh(mesh)
        if mesh is None:
            self.cache = model.init_cache(cfg, batch_slots, max_len,
                                          device=self.device)
            # the batch-1 cache every prefill writes before its slot copy
            self.cache1 = model.init_cache(cfg, 1, max_len,
                                           device=self.device)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.budget = np.zeros(batch_slots, np.int32)
        self.cur = np.zeros(batch_slots, np.int32)   # last sampled token
        self.last_stats: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._prefill_steps: dict = {}      # prompt length -> prefill step
        self.compile_misses = 1
        self._decode = self._step(self._decode_fn)

    def _mesh(self, mesh):
        """The tensor-parallel layout of a rank of ``mesh`` (module
        docstring): the steps' axes, the slots' rows this rank holds
        (``rows``), and its caches.  Without a mesh: one device."""
        self.mesh, self.tp = mesh, Axis(mesh, "model")
        self.decode_tp, self.brep, self.batch_axes = self.tp, None, []
        self.rows = slice(0, self.batch)
        if mesh is None:
            return
        from repro_torch.serve import steps
        cfg, lm = self.cfg, self.model
        layout = steps.serve_layout(lm, cfg, mesh)
        extents = mesh_shape(mesh)
        dmesh, factored = mesh, False
        if cfg.factored_decode and steps.decode_split(cfg, extents):
            dmesh, _, _ = steps.decode_mesh_plan(cfg, mesh)
            factored = True
            self.decode_tp, self.brep = Axis(dmesh, "kvh"), Axis(dmesh, "brep")
            kv = ("k", "v", "xk", "xv", "shared_k", "shared_v", "length")
            if any(k not in kv for k in lm.init_cache(
                    cfg, 1, 1, device="meta")):
                raise NotImplementedError(
                    f"{cfg.arch_id}: the factored decode plan holds KV "
                    "caches only")
            self._flat = layout
            self._kvh = steps.kvh_shapes(lm, cfg, dmesh)
        dext = mesh_shape(dmesh)
        self.cache = steps.init_local_cache(
            lm, cfg, self.batch, self.max_len, dext, layout,
            factored=factored, device=self.device)
        self.cache1 = steps.init_local_cache(
            lm, cfg, 1, self.max_len, extents, layout, device=self.device)
        n = self.cache["length"].shape[0]
        if n < self.batch:
            self.batch_axes = [Axis(dmesh, a) for a in ("data", "brep")
                               if a in dext and dext[a] > 1]
            j = coll.dp_index(self.batch_axes)
            self.rows = slice(j * n, (j + 1) * n)

    def _step(self, fn):
        return (graphs_lib.CapturedStep(fn, pool=self._pool) if self.graphs
                else fn)

    def _decode_params(self):
        """The parameters a decode step computes with: the rank's slices,
        or under the factored plan its 'kvh' slices
        (``serve.steps.factored_params``)."""
        if self.brep is None:
            return self.params
        from repro_torch.serve import steps
        return steps.factored_params(self.params, self._flat, self._kvh,
                                     self.brep, self.decode_tp)

    def _decode_fn(self, tokens):
        """One batched decode step on the slot cache, (B, 1) tokens ->
        (B, 1, V) logits (the rank's rows, and its share of the
        vocabulary); the new lengths written back in place."""
        with tensor.model_parallel(self.decode_tp):
            logits, cache = self.model.decode_step(
                self._decode_params(), self.cfg, tokens, self.cache)
        self.cache["length"].copy_(cache["length"])
        return logits

    def _prefill_fn(self, prompt):
        """Prefill of one (1, S) prompt into the zeroed batch-1 cache ->
        (1, 1, V) logits (the rank's share of the vocabulary)."""
        for t in self.cache1.values():
            t.zero_()
        with tensor.model_parallel(self.tp):
            logits, cache = self.model.prefill(self.params, self.cfg, prompt,
                                               self.cache1)
        self.cache1["length"].copy_(cache["length"])
        return logits

    def greedy(self, logits, axis=None):
        """Greedy tokens of logits over the rank's share of the vocabulary
        (of the decode step's axis, or ``axis``)."""
        with tensor.model_parallel(axis or self.decode_tp):
            return tensor.greedy(logits, self.cfg.vocab)

    def _prefill1(self, prompt):
        """The prefill step of this prompt's length, built at its first use."""
        n = prompt.shape[1]
        if n not in self._prefill_steps:
            self.compile_misses += 1
            self._prefill_steps[n] = self._step(self._prefill_fn)
        return self._prefill_steps[n](prompt)

    def _insert(self, slot: int, req: Request):
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        logits = self._prefill1(prompt)
        # copy the batch-1 cache into this slot, where this rank holds it
        if self.rows.start <= slot < self.rows.stop:
            row = slot - self.rows.start
            for key, dst in self.cache.items():
                src = self.cache1[key]
                if key == "length":
                    dst[row] = src[0]
                    continue
                src = src[:, 0]
                if dst.shape[-2] != src.shape[-2]:    # KV heads over 'kvh'
                    n = dst.shape[-2]
                    src = src.narrow(-2, self.decode_tp.index * n, n)
                dst[:, row] = src
        req.generated = []
        self.slots[slot] = req
        # the prefill's last logits already give generated token #1
        self.budget[slot] = req.max_new_tokens - 1
        self.cur[slot] = int(self.greedy(logits[0, -1], self.tp))
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
            tokens = torch.as_tensor(self.cur[self.rows],
                                     device=self.device)[:, None]
            logits = self._decode(tokens)
            nxt = coll.gather_rows(self.greedy(logits[:, 0]),
                                   self.batch_axes).cpu().numpy()
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
