"""Checkpoints and the step watchdog (counterpart of
``repro/train/checkpoint.py``), in the reference's on-disk format, so a
checkpoint written by either package restores in the other.

* Atomic: written to ``<dir>/tmp.<step>.<pid>``, fsynced, renamed to
  ``step_<%010d>``; a crash mid-write never corrupts the latest checkpoint.
* Format: ``arrays.npz`` holding the leaves as ``a0..an`` and
  ``manifest.json`` holding ``step``, ``names``, ``dtypes``, ``shapes``,
  ``time`` and ``meta``.  ``names`` are the JAX key strings of the
  reference's tree in JAX's flatten order (dict keys sorted, a NamedTuple's
  fields in field order, sequences by index): ``['opt'].mu['evoformer']...``.
  This module makes them itself, without JAX (:func:`_flatten_with_names`).
  A dtype numpy cannot hold (bf16, fp8) is stored as its uint8 bytes with
  the logical dtype in the manifest, and read back through torch.
* Restore copies INTO the tensors of the tree it is given and never rebinds
  one, so captured CUDA graphs, which read fixed addresses, go on reading
  the restored values; a structure, shape or dtype mismatch raises.
* The train state goes to disk in the reference's layout
  (:func:`train_state_tree`): the stacks' block tensors are one leaf with a
  leading block axis (``bridge.nest``, the layout
  ``bridge.state_dict_to_params`` writes).
* ``CheckpointManager``: keep-N garbage collection, serialization on a worker
  thread (``wait()`` joins it), and a final save on SIGTERM.  ``save``
  snapshots the tensors to host memory before it returns (non-blocking
  copies into pinned buffers, then one synchronize), since the next graph
  replay overwrites them in place; the worker thread only writes numpy.
* ``StepWatchdog``: straggler detection on an EMA of step walls.

A training run stamps its plan's metadata (``BuiltPlan.metadata()``: the
plan and the mesh fingerprint) into every manifest, and a restore under a
different plan raises :class:`PlanMismatchError` unless ``adapt_plan``.
Under a plan of several ranks only the writer (global rank 0) saves; every
rank restores.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import signal
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.bridge import Stacked
from repro_torch.obs import MetricRegistry


# ---------------------------------------------------------------------------
# Names and leaves
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree, prefix: str = ""):
    """(names, leaves) of ``tree`` in JAX's flatten order, each name as
    ``jax.tree_util.keystr`` writes it.  Containers: dicts (keys sorted),
    NamedTuples (fields in order), lists and tuples; anything else (a
    tensor, :class:`Stacked`, a numpy array, a Python number) is a leaf."""
    names, leaves = [], []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [prefix], [tree]
    for key, sub in items:
        n, leaf = _flatten_with_names(sub, prefix + key)
        names += n
        leaves += leaf
    return names, leaves


def _unflatten_like(tree, leaves):
    """``tree`` with its leaves replaced, in flatten order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


class _OptState(NamedTuple):
    """The reference's ``OptState`` layout (``step``, ``mu``, ``nu``)."""
    step: Any
    mu: Any
    nu: Any


def train_state_tree(state: dict, *, stacked=bridge.STACKED) -> dict:
    """The port's train state (``trainstep.init_state``) as the reference's
    tree: ``params`` (the model's parameters, or a dict of tensors by key
    path), ``opt`` (``step`` as an int32 array, ``mu``, ``nu``), ``ema``
    when kept and ``err`` (the int8 error feedback of
    ``compress_pod_grads``) when kept; leaves are the live tensors (stack
    blocks as :class:`Stacked`), so a restore into this tree writes the
    training state itself."""
    opt, params = state["opt"], state["params"]
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    tree = {"params": bridge.nest(params, stacked=stacked),
            "opt": _OptState(np.asarray(opt.step, np.int32),
                             bridge.nest(opt.mu, stacked=stacked),
                             bridge.nest(opt.nu, stacked=stacked))}
    for key in ("ema", "err"):
        if key in state:
            tree[key] = bridge.nest(state[key], stacked=stacked)
    return tree


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

_NATIVE = {np.dtype(d) for d in
           ("float64", "float32", "float16", "int64", "int32", "int16",
            "int8", "uint64", "uint32", "uint16", "uint8", "bool")}


def _dtype_name(dtype) -> str:
    """The manifest's dtype string: numpy's name (``float32``, ``bool``,
    ``bfloat16`` ...) for a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


_TORCH_NATIVE = {torch.float64, torch.float32, torch.float16, torch.int64,
                 torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}


def _encode(arr) -> np.ndarray:
    """A host leaf as npz stores it: native dtypes as they are, a dtype
    numpy lacks (bf16, fp8) as a uint8 view of its bytes (the reference's
    layout: the last axis widened by the item size)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype in _TORCH_NATIVE:
            return arr.numpy()
        return arr.contiguous().view(torch.uint8).numpy()
    arr = np.asarray(arr)
    if arr.dtype in _NATIVE:
        return arr
    return np.ascontiguousarray(arr).view(np.uint8)


def _decode(arr: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A stored array -> a CPU tensor of the logical dtype and shape; a
    non-native dtype is reinterpreted from its uint8 bytes through torch."""
    if np.dtype(arr.dtype) in _NATIVE and str(arr.dtype) == dtype:
        return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    dt = getattr(torch, dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {dtype!r} has no torch dtype")
    raw = torch.from_numpy(np.ascontiguousarray(arr.reshape(-1)))
    return raw.view(dt).reshape(tuple(shape))


# ---------------------------------------------------------------------------
# Host snapshots
# ---------------------------------------------------------------------------

def snapshot(tree):
    """``tree`` with every tensor (and :class:`Stacked`) leaf copied to host
    memory: non-blocking copies into pinned buffers when a leaf lies on a
    card, then one synchronize.  Other leaves become numpy arrays."""
    devices = set()

    def leaf_to_host(leaf):
        if not isinstance(leaf, (Stacked, torch.Tensor)):
            return np.array(leaf)
        stacked = isinstance(leaf, Stacked)
        parts = leaf.parts if stacked else [leaf]
        pin = parts[0].device.type == "cuda"
        buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=pin)
        for dst, part in zip(buf if stacked else [buf], parts):
            dst.copy_(part.detach(), non_blocking=pin)
        devices.add(parts[0].device)
        return buf

    _, leaves = _flatten_with_names(tree)
    host = _unflatten_like(tree, [leaf_to_host(x) for x in leaves])
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return host


# ---------------------------------------------------------------------------
# Plan metadata
# ---------------------------------------------------------------------------

class PlanMismatchError(ValueError):
    """Checkpoint was written under a different ParallelPlan/mesh than the
    one restoring it; the message lists the differing fields."""


def _diff_meta(stored: dict, current: dict, prefix="") -> list:
    out = []
    for k in sorted(set(stored) | set(current)):
        a, b = stored.get(k), current.get(k)
        if isinstance(a, dict) and isinstance(b, dict):
            out.extend(_diff_meta(a, b, prefix=f"{prefix}{k}."))
        elif a != b:
            out.append(f"{prefix}{k}: checkpoint={a!r} current={b!r}")
    return out


def check_plan_meta(stored: Optional[dict], current: Optional[dict], *,
                    adapt: bool = False):
    """Compare stored vs current plan metadata.

    Plan field mismatches are fatal unless ``adapt=True``; an empty meta on
    either side passes, and mesh-fingerprint differences alone are always
    allowed (the format is mesh-agnostic)."""
    if not stored or not current or adapt:
        return
    diffs = _diff_meta(stored.get("plan", {}), current.get("plan", {}))
    if diffs:
        raise PlanMismatchError(
            "checkpoint was written under a different ParallelPlan:\n  "
            + "\n  ".join(diffs)
            + "\npass adapt_plan=True (launcher: --adapt-plan) to restore "
            "anyway — arrays are mesh-agnostic and re-shard, but optimizer "
            "dynamics and dropout streams may differ across layouts")


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(directory, step: int, tree, *,
                    meta: Optional[dict] = None) -> pathlib.Path:
    """Write ``tree`` as ``<directory>/step_<%010d>`` (atomically).  Leaves on
    a card are copied to the host first (:func:`snapshot`)."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp.{step}.{os.getpid()}"
    final = directory / f"step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    names, leaves = _flatten_with_names(tree)
    if any(isinstance(x, Stacked) or (isinstance(x, torch.Tensor)
                                      and x.device.type != "cpu")
           for x in leaves):
        names, leaves = _flatten_with_names(snapshot(tree))
    logical = [x.detach() if isinstance(x, torch.Tensor) else np.asarray(x)
               for x in leaves]
    arrays = {f"a{i}": _encode(a) for i, a in enumerate(logical)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "names": names,
        "dtypes": [_dtype_name(a.dtype) for a in logical],
        "shapes": [list(a.shape) for a in logical],
        "time": time.time(),
        "meta": meta or {},
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def checkpoint_meta(directory, step: Optional[int] = None) -> dict:
    """The ``meta`` dict recorded at save time."""
    directory = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    manifest = json.loads(
        (directory / f"step_{step:010d}" / "manifest.json").read_text())
    return manifest.get("meta", {})


def _copy_into(leaf, value: torch.Tensor, name: str):
    """Write ``value`` into a tensor or :class:`Stacked` leaf in place."""
    if tuple(leaf.shape) != tuple(value.shape) or leaf.dtype != value.dtype:
        raise ValueError(f"checkpoint leaf {name}: {tuple(value.shape)} "
                         f"{value.dtype}, the tree holds {tuple(leaf.shape)} "
                         f"{leaf.dtype}")
    with torch.no_grad():
        if isinstance(leaf, Stacked):
            for i, part in enumerate(leaf.parts):
                part.copy_(value[i])
        else:
            leaf.copy_(value)
    return leaf


def restore_checkpoint(directory, tree_like, *, step: Optional[int] = None,
                       expect_meta: Optional[dict] = None,
                       adapt_plan: bool = False):
    """Restore the checkpoint at ``step`` (default: the latest) into
    ``tree_like``: every tensor and :class:`Stacked` leaf is overwritten in
    place; any other leaf (the optimizer's step) is replaced by the stored
    value as a numpy array.  Returns (the tree, the step).  The names must
    equal the tree's, each shape and dtype its leaf's, else ValueError;
    ``expect_meta`` is checked against the stored meta
    (:func:`check_plan_meta`)."""
    directory = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    check_plan_meta(manifest.get("meta"), expect_meta, adapt=adapt_plan)
    names, leaves = _flatten_with_names(tree_like)
    if names != manifest["names"]:
        raise ValueError("checkpoint structure mismatch: "
                         f"{sorted(set(names) ^ set(manifest['names']))[:8]}")
    out = []
    with np.load(path / "arrays.npz") as data:
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            value = _decode(data[f"a{i}"], manifest["dtypes"][i],
                            manifest["shapes"][i])
            if isinstance(leaf, (torch.Tensor, Stacked)):
                out.append(_copy_into(leaf, value, name))
            else:
                want = np.asarray(leaf)
                got = value.numpy()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise ValueError(f"checkpoint leaf {name}: {got.shape} "
                                     f"{got.dtype}, the tree holds "
                                     f"{want.shape} {want.dtype}")
                out.append(got.copy())
    return _unflatten_like(tree_like, out), step


def checkpoint_bytes(directory, step: Optional[int] = None) -> int:
    """Bytes on disk of one checkpoint directory."""
    directory = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    return sum(p.stat().st_size
               for p in (directory / f"step_{step:010d}").iterdir())


class CheckpointManager:
    """Keep-N asynchronous checkpoint manager with a final save on SIGTERM.

    ``write=False`` (a rank other than the writer of a plan of several
    ranks) makes :meth:`save` a no-op; restores read the writer's files.
    ``obs`` (a ``MetricRegistry``; None: one of its own) records the seconds
    of each snapshot (``ckpt/snapshot_s``, on the caller's thread: device to
    pinned host memory), save (``ckpt/save_s``, on the worker: npz write,
    fsync, rename and garbage collection) and restore (``ckpt/restore_s``);
    ``stats[k]`` is the live series ``obs.series(f"ckpt/{k}")``."""

    def __init__(self, directory, *, keep: int = 3, async_save: bool = True,
                 install_sigterm: bool = False,
                 plan_meta: Optional[dict] = None, write: bool = True,
                 obs=None):
        self.directory = pathlib.Path(directory)
        self.write = write
        self.keep = keep
        self.async_save = async_save
        self.plan_meta = plan_meta
        self.obs = obs if obs is not None else MetricRegistry()
        self.stats = {k: self.obs.series(f"ckpt/{k}")
                      for k in ("snapshot_s", "save_s", "restore_s")}
        self._thread: Optional[threading.Thread] = None
        self._last_state = None
        self._lock = threading.Lock()
        if install_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):  # pragma: no cover - signal path
        self.wait()
        with self._lock:
            if self._last_state is not None:
                step, tree = self._last_state
                save_checkpoint(self.directory, step, tree,
                                meta=self.plan_meta)
        raise SystemExit(143)

    def save(self, step: int, tree):
        """Snapshot ``tree`` to host memory now (the caller may overwrite its
        tensors as soon as this returns), then write it on the worker."""
        if not self.write:
            return
        t0 = time.perf_counter()
        host_tree = snapshot(tree)
        self.obs.record("ckpt/snapshot_s", time.perf_counter() - t0, step=step)
        self.wait()
        with self._lock:
            self._last_state = (step, host_tree)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree)

    def _save_and_gc(self, step, tree):
        t0 = time.perf_counter()
        save_checkpoint(self.directory, step, tree, meta=self.plan_meta)
        steps = sorted(int(m.group(1)) for p in self.directory.iterdir()
                       if (m := re.fullmatch(r"step_(\d+)", p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:010d}", ignore_errors=True)
        self.obs.record("ckpt/save_s", time.perf_counter() - t0, step=step)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore(self, tree_like, *, step: Optional[int] = None,
                adapt_plan: bool = False):
        """Restore the checkpoint at ``step`` (default: the latest) into
        ``tree_like`` (see :func:`restore_checkpoint`)."""
        t0 = time.perf_counter()
        out = restore_checkpoint(self.directory, tree_like, step=step,
                                 expect_meta=self.plan_meta,
                                 adapt_plan=adapt_plan)
        self.obs.record("ckpt/restore_s", time.perf_counter() - t0,
                        step=out[1])
        return out

    def restore_latest(self, tree_like, *, adapt_plan: bool = False):
        return self.restore(tree_like, adapt_plan=adapt_plan)


class StepWatchdog:
    """Straggler/hang detection for synchronous training.

    Tracks an EMA of step wall-time; flags steps slower than
    ``threshold x EMA`` and calls ``on_straggler(step, dt, ema)``.  An
    outlier does not enter the EMA.
    """

    def __init__(self, *, threshold: float = 2.0, decay: float = 0.9,
                 on_straggler: Optional[Callable[[int, float, float], Any]] = None):
        self.threshold = threshold
        self.decay = decay
        self.ema: Optional[float] = None
        self.flagged: list[tuple[int, float]] = []
        self.on_straggler = on_straggler
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        is_straggler = False
        if self.ema is not None and dt > self.threshold * self.ema:
            is_straggler = True
            self.flagged.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
            # do not poison the EMA with the outlier
        else:
            self.ema = dt if self.ema is None else (
                self.decay * self.ema + (1 - self.decay) * dt)
        return is_straggler
