"""Rank processes: start a world of them, or join one that ``torchrun``
started, with a time limit on every wait.

The port runs one process per rank.  The backend is chosen explicitly
(:func:`choose_backend`): NCCL when every rank has a card of its own, gloo
for CPU ranks and for ranks that share one card.  Every process group gets
a timeout, so a rank that dies cannot leave the others blocked in a
collective for ever, and :func:`spawn` joins its ranks against a deadline:
a rank's exception fails the run, and a rank still alive at the deadline is
terminated.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import socket
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def choose_backend(device_type: str, world: int) -> str:
    """``nccl`` when each of the ``world`` ranks has a card of its own,
    ``gloo`` for CPU ranks and for ranks that share a card (NCCL refuses
    two ranks on one GPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, backend: str, local_rank: int) -> torch.device:
    """The device a rank computes on: the CPU, its own card under NCCL, or
    the card it shares (local rank modulo the cards) under gloo."""
    if device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device visible: pass device='cpu' to run "
                           "the ranks on the CPU")
    return torch.device("cuda", local_rank if backend == "nccl" else
                        local_rank % n)


def describe_backend(device_type: str, backend: str, world: int) -> str:
    if device_type == "cpu":
        return f"backend gloo: {world} CPU ranks"
    if backend == "nccl":
        return f"backend nccl: {world} ranks, one card each"
    return (f"backend gloo: {world} ranks share {torch.cuda.device_count()} "
            "card(s); collectives staged through host memory")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, *, backend: str, port: int,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def resolve_device_type(device_type: Optional[str]) -> str:
    """``device_type`` as given, or ``cuda`` for None (raising without a
    card, as ``device.resolve_device`` does): ranks run on the CPU only
    when the caller asks for it."""
    return device_type or resolve_device(None).type


def from_env(device_type: Optional[str] = None,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple:
    """Join the world ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns (rank, world,
    device, backend), or None outside such a world.  ``device_type``:
    None is ``cuda`` (:func:`resolve_device_type`)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    device_type = resolve_device_type(device_type)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = choose_backend(device_type, world)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    device = rank_device(device_type, backend, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return rank, world, device, backend


def _rank_main(rank, fn, world, port, backend, device_type, timeout_s,
               threads, args, queue):
    if threads:
        torch.set_num_threads(threads)
    init_rank(rank, world, backend=backend, port=port, timeout_s=timeout_s)
    try:
        device = rank_device(device_type, backend, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        queue.put((rank, fn(rank, world, device, *args)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device_type: Optional[str] = None,
          backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: int = 0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (start method ``spawn``; ``fn`` must be importable), each rank on
    ``device_type`` (None: ``cuda``, raising without a card; the CPU only
    when ``"cpu"`` is passed) in a process group of ``backend`` (default
    :func:`choose_backend`) with
    ``timeout_s`` on its collectives.  ``threads``: torch intra-op threads
    per rank (0: torch's default).  Returns the ranks' return values in
    rank order.  Raises the first rank failure, or TimeoutError when the
    ranks are not all done within ``timeout_s``; no rank outlives the call."""
    device_type = resolve_device_type(device_type)
    backend = backend or choose_backend(device_type, world)
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, free_port(), backend, device_type,
                          timeout_s, threads, args, queue),
        nprocs=world, join=False, start_method="spawn")
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while True:
            while not queue.empty():
                rank, out = queue.get()
                results[rank] = out
            if ctx.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks not done within "
                                   f"{timeout_s:.0f} s")
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(timeout=10)
    return [results[r] for r in range(world)]


@contextlib.contextmanager
def virtual_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` (0 by default) of a world of
    ``world_size`` ranks that do not exist: torch's fake process group,
    whose collectives return outputs of the right shapes and move nothing.
    The dry run (``launch/dryrun.py``) traces one rank's step on ``meta``
    tensors inside it, over meshes of the production size; every mesh and
    plan builds as on a real world, from that rank's view.  The group is
    destroyed on exit, so one process can open worlds of several sizes in
    turn; opening one inside another raises."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:   # the fake backend registers on this import
        raise RuntimeError(
            "this torch has no fake process group (torch.testing._internal."
            "distributed.fake_pg): the dry run's virtual world needs it") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already open: the virtual "
                           "world needs the process to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
