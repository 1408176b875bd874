"""Gradient synchronization: plain sums and int8 error-feedback compression
(counterpart of ``repro/parallel/grad_sync.py``).

The compressed path targets the cross-pod hop of a multi-pod mesh, where
bandwidth per link is scarcest: gradients are averaged exactly over the
intra-pod ``data`` axis, then quantized to int8 against one shared scale per
tensor for the ``pod`` sum.  The quantization error is carried in an
error-feedback accumulator (Seide et al., 2014), so the compression is
unbiased over time.

Gradient trees are dicts of tensors by key path; every function here runs
without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh_utils import Axis


def psum_tree(tree: dict, axis: Axis) -> dict:
    return coll.psum_tree(tree, (axis,))


def pmean_tree(tree: dict, axis: Axis) -> dict:
    return coll.pmean_tree(tree, (axis,))


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def compressed_psum_tree(grads: dict, axis: Axis, error_state: dict):
    """int8 error-feedback sum over ``axis``; returns (the summed gradients
    in fp32, the new error state).

    ``error_state`` holds each leaf's residual from the previous step
    (:func:`zeros_error_state` to start).  Each leaf plus its residual is
    quantized against the max over the axis of the leaves' own scales
    (amax / 127; one small max-reduce for every leaf's scale together), the
    int8 payloads are summed in int32 (exact for the <= 127 * n range) in one
    all-reduce, and rescaled by the shared scale."""
    keys = list(grads)
    g32 = [grads[k].float() + error_state[k] for k in keys]
    amax = torch.stack([g.abs().max() for g in g32]).float()
    scale = coll.pmax(torch.clamp(amax, min=1e-30) / 127.0, axis)
    q = [_quantize(g, s) for g, s in zip(g32, scale)]
    new_err = {k: g - qq.float() * s
               for k, g, qq, s in zip(keys, g32, q, scale)}
    total = coll.psum_tree({k: qq.to(torch.int32) for k, qq in zip(keys, q)},
                           (axis,))
    reduced = {k: total[k].float() * s for k, s in zip(keys, scale)}
    return reduced, new_err


def zeros_error_state(grads: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
