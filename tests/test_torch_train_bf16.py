"""The port's bf16 training loss against the JAX package's ``loss_fn`` (bf16
forward, fp32 heads on the fp32 masters), at af2_tiny widths.

Tolerance: 2e-2 of the loss, relative.  Both sides round every op's output
to bf16 but in different places (the port's kernel path keeps attention
probabilities and the triangle LayerNorm input in fp32 where JAX's chunked
path rounds them), so the trunk's outputs differ by bf16 noise; the fp32
losses on top of them inherit it.  A wrong gradient path or loss term moves
the loss by O(1).
"""
import jax
import jax.numpy as jnp
import torch

from repro.core import model as jaf2
from repro.core.config import af2_tiny

from repro_torch import bridge
from repro_torch.core import model as taf2
from repro_torch.data.protein import protein_batch

from torch_util import af2_tree, port_cfg, randomize_np

CFG = af2_tiny()
PCFG = port_cfg(CFG)
RTOL = 2e-2


def test_bf16_loss_matches_jax_loss_fn():
    params = randomize_np(af2_tree(CFG), seed=5)
    sample = {k: v[1] for k, v in protein_batch(0, 0, 2, PCFG).items()}
    loss_j, metrics_j = jax.jit(lambda p, b: jaf2.loss_fn(p, CFG, b))(
        params, {k: jnp.asarray(v) for k, v in sample.items()})
    model = bridge.load_jax_params(taf2.AlphaFold2(PCFG, device="cpu"),
                                   params)
    loss, metrics = taf2.loss_fn(model, PCFG, sample)   # bf16 by default
    loss.backward()
    assert metrics["fape"].dtype == torch.float32
    for k in ("loss", "fape", "distogram", "masked_msa", "plddt"):
        want = float(metrics_j[k])
        assert abs(metrics[k].item() - want) <= RTOL * abs(want), k
    # the gradients reach the fp32 masters through the bf16 cast
    grads = [p.grad for p in model.parameters()]
    assert all(g is None or g.dtype == torch.float32 for g in grads)
    assert sum(1 for g in grads if g is not None and bool(g.abs().sum() > 0)) \
        > 0.9 * len(grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads if g is not None)
