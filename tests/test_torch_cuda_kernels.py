"""The port's CUDA kernels against their plain versions, on the card.

Marker ``cuda``: every test here needs an NVIDIA GPU and skips without one
(the ``cuda_dev`` fixture decides at run time).  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.

Tolerance: |kernel - plain| <= atol + rtol * |plain| elementwise.  fp32:
atol 2e-4 (the reference's kernel tolerance, tests/test_kernels.py), rtol
1e-5.  bf16: atol 3e-2 (the reference's bf16 tolerance), rtol 2^-7 — the
kernel and its plain version do the same fp32 arithmetic in another order,
so a bf16 output (or a staged bf16 projection) may round one ulp apart.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import evo_attention as ka
from repro_torch.kernels import ref
from repro_torch.kernels import triangle as kt

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-4, 1e-5), torch.bfloat16: (3e-2, 2.0 ** -7)}


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    d = (got.float() - want.float()).abs()
    excess = (d - atol - rtol * want.float().abs()).max().item()
    assert excess <= 0.0, f"max |diff| {d.max().item()} over tolerance"


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dtype, dev, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,S,H,C,biased,gated", [
    (3, 37, 2, 4, True, True),     # ragged S, af2_tiny extra width
    (2, 100, 4, 8, True, False),   # ragged S, extra-stack width
    (2, 130, 3, 16, False, True),  # two query tiles, no bias
    (4, 256, 4, 32, True, True),   # triangle attention width
])
def test_evo_attention_kernel_matches_plain(cuda_dev, dtype, L, S, H, C,
                                            biased, gated):
    rng = np.random.default_rng(L * 1000 + S)
    q, k, v, g = (_t(rng, (L, S, H, C), dtype, cuda_dev) for _ in range(4))
    bias = _t(rng, (H, S, S), torch.float32, cuda_dev) if biased else None
    if biased:
        bias[:, :, S // 2:] = -1e9      # masked keys, as mask_bias folds them
    gate = g if gated else None
    got = ka.evo_attention_fwd(q, k, v, bias, gate)
    want = ref.evo_attention_ref(q, k, v, bias, gate)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


def test_evo_attention_kernel_bf16_bias(cuda_dev):
    rng = np.random.default_rng(5)
    q, k, v, g = (_t(rng, (2, 64, 2, 8), torch.bfloat16, cuda_dev)
                  for _ in range(4))
    bias = _t(rng, (2, 64, 64), torch.bfloat16, cuda_dev)
    got = ka.evo_attention_fwd(q, k, v, bias, g)
    want = ref.evo_attention_ref(q, k, v, bias, g)
    _assert_close(got, want, torch.bfloat16)


def _tri_args(rng, r, c_z, c, dtype, dev):
    xa = _t(rng, (r, r, c_z), dtype, dev)
    w = lambda *s: _t(rng, s, dtype, dev, scale=s[0] ** -0.5)
    bvec = lambda n: _t(rng, (n,), dtype, dev, scale=0.5)
    return (xa, w(c_z, 2 * c), bvec(2 * c), w(c_z, 2 * c), bvec(2 * c),
            1.0 + bvec(c), bvec(c), w(c, c_z), bvec(c_z), w(c_z, c_z),
            bvec(c_z))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c_z,c,outgoing,masked", [
    (16, 16, 16, True, False),     # af2_tiny widths
    (37, 16, 16, False, True),     # ragged r, incoming, masked
    (100, 128, 128, True, True),   # ragged r at af2_initial width
])
def test_triangle_kernel_matches_plain(cuda_dev, dtype, r, c_z, c, outgoing,
                                       masked):
    rng = np.random.default_rng(r + c)
    x, *w = _tri_args(rng, r, c_z, c, dtype, cuda_dev)
    xab = x if outgoing else x.transpose(0, 1)
    km = None
    if masked:
        km = torch.ones(r, device=cuda_dev)
        km[r - r // 4:] = 0.0
    got = kt.triangle_mult_fwd(xab, xab, x, *w, k_mask=km)
    want = ref.triangle_mult_ref(xab, xab, x, *w, k_mask=km)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


def test_kernel_launch_counters(cuda_dev):
    rng = np.random.default_rng(0)
    q = _t(rng, (1, 8, 1, 4), torch.float32, cuda_dev)
    before = ka.launches
    ka.evo_attention_fwd(q, q, q, None, None)
    assert ka.launches == before + 1
    x, *w = _tri_args(rng, 8, 16, 16, torch.float32, cuda_dev)
    before = kt.launches
    kt.triangle_mult_fwd(x, x, x, *w)
    assert kt.launches == before + 1


def test_kernel_rejects_bad_input(cuda_dev):
    q = torch.zeros((1, 8, 1, 12), device=cuda_dev)
    with pytest.raises(ValueError, match="head dim"):
        ka.evo_attention_fwd(q, q, q, None, None)
    q = torch.zeros((1, 8, 2, 8), device=cuda_dev)
    with pytest.raises(ValueError, match="contiguous"):
        ka.evo_attention_fwd(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                             q, None, None)
