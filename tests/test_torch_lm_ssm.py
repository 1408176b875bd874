"""The port's Mamba2 (``repro_torch.models.ssm``) and Zamba2-style hybrid
(``repro_torch.models.hybrid``) serving functions and ``DecodeEngine``
against the JAX package, on the CPU.

Weights come from the JAX init plus numpy noise, carried through ``bridge``
(the layer axis split across ``layers``; the hybrid's ``shared`` block is
not stacked); inputs are numpy arrays from a seed.  Configs: each family's
``get_smoke_config`` (d 128; mamba2: 8 heads of 32, state 16, chunk 8;
zamba2: 2 layers, the shared block at layer 0, 4 heads of 32) and one
narrower case, a hybrid whose backbone is mamba2 blocks at d 48 (6 heads
of 16, state 8, chunk 4; 3 layers, the shared block at layers 0 and 2).
Prompts of 13 tokens, no multiple of either chunk; the SSD functions also
at 16.

Tolerances, as ``tests/test_torch_lm_model.py`` states them: fp32 within
1e-5 where the JAX function is policy-free (the SSD functions, the blocks
on fp32 weights); at the reference's bf16 cast within atol + 2^-7 |JAX|,
atol the larger of 3e-2 and twice the reference's own bf16 - fp32 error on
the same input.  Under an fp32 policy on both sides the top-level functions
agree within 1e-5 of the largest |logit|.  The prefill's final state S,
taken from the chunked pass, against the reference's scan over every
prompt token: fp32, max |dS| <= 1e-4 max |S| (observed: below 1e-6 max |S|
at these widths).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro.nn.attention import attention as jax_attention
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest

from repro_torch import bridge
from repro_torch.models import get_model
from repro_torch.models import hybrid as thybrid
from repro_torch.models import ssm as tssm
from repro_torch.nn.attention import attention
from repro_torch.nn.layers import Policy
from repro_torch.serve.engine import DecodeEngine, Request

from test_torch_lm_model import assert_bf16_close, port_cfg, ref_serve_both
from torch_util import lm_tree, max_abs, t

CFGS = {
    "mamba2_smoke": lambda: jax_smoke_config("mamba2-2.7b", scan_layers=True),
    "zamba2_smoke": lambda: jax_smoke_config("zamba2-7b", scan_layers=True),
    # the narrower case: its backbone is mamba2 blocks at d 48
    "zamba2_narrow": lambda: jax_smoke_config(
        "zamba2-7b", scan_layers=True, n_layer=3, d_model=48, n_head=4,
        n_kv_head=2, d_head=12, d_ff=64, vocab=61, ssm_state=8,
        ssm_head_dim=16, ssm_chunk=4, attention_chunk=16),
}

JAX = {"ssm": jssm, "hybrid": jhybrid}
PORT = {"ssm": tssm, "hybrid": thybrid}


@functools.lru_cache(maxsize=None)
def loaded(name: str):
    """(config, JAX params (numpy), the port's model loaded with them)."""
    cfg = CFGS[name]()
    model = PORT[cfg.family].init_params(port_cfg(cfg), device="cpu")
    params = lm_tree(model, cfg, 1)
    bridge.load_jax_params(model, params, stacked=bridge.LM_STACKED)
    return cfg, params, model


@pytest.fixture(params=sorted(CFGS))
def setup(request):
    return loaded(request.param)


def test_init_params_keys_shapes_and_bridge_round_trip(setup):
    """The port's init has the reference's keys and shapes (its
    deterministic leaves, dt_bias, A_log and D, its values); the loaded
    model goes back to the reference's tree unchanged.  The reference's
    shapes come from ``jax.eval_shape`` of its init, the deterministic
    leaves from one of its blocks (jitted alone: the whole init's compile
    takes 2.5-4 s)."""
    cfg, params, model = setup
    shapes = jax.eval_shape(lambda k: JAX[cfg.family].init_params(k, cfg),
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in bridge.flatten(shapes).items()}
    block = jax.jit(lambda k: jssm.block_init(k, cfg))(jax.random.PRNGKey(0))
    got = bridge.flatten(bridge.state_dict_to_params(
        PORT[cfg.family].init_params(port_cfg(cfg), seed=0,
                                     device="cpu").state_dict(),
        stacked=bridge.LM_STACKED))
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w, key
        leaf = key.rsplit(".", 1)[-1]
        if key.startswith("layers.") and leaf in ("dt_bias", "A_log", "D"):
            for layer in got[key]:      # one row a stacked layer
                assert max_abs(t(layer), block[leaf]) < 1e-6, key
    back = bridge.state_dict_to_params(model.state_dict(),
                                       stacked=bridge.LM_STACKED)
    assert set(back) == set(params)
    for key, leaf in bridge.flatten(params).items():
        np.testing.assert_array_equal(bridge.flatten(back)[key], leaf)


def _ssd_inputs(seed, t_len, h=6, p=16, n=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(t_len, h) - 1.0))            # softplus: > 0
    A = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    return f(t_len, h, p), dt, A, f(t_len, n), f(t_len, n), f(h)


@pytest.mark.parametrize("t_len", [16, 13])
def test_ssd_chunked_and_reference_match_jax_fp32(t_len):
    """At a sequence length that is a multiple of the chunk (16) and one
    that is not (13: the pad steps are inert); the chunked form's final
    state against the recurrence run to the end."""
    args = _ssd_inputs(t_len, t_len)
    targs = [t(a) for a in args]
    want_ref = jssm.ssd_reference(*map(jnp.asarray, args))
    want = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    got_ref = tssm.ssd_reference(*targs)
    got, S = tssm.ssd_chunked(*targs, chunk=8, return_state=True)
    assert max_abs(got_ref, want_ref) < 1e-5
    assert max_abs(got, want) < 1e-5
    assert max_abs(got, want_ref) < 1e-5
    # batched: leading dims are batch dims
    got2 = tssm.ssd_chunked(*[torch.stack([a, a]) if a.dim() > 1 else a
                              for a in targs], chunk=8)
    assert max_abs(got2[1], want) < 1e-5
    S_scan = torch.zeros_like(S)
    x, dt, A, B, _, _ = targs
    for i in range(t_len):
        S_scan, _ = tssm.ssd_decode_step(S_scan, x[i], dt[i], A, B[i],
                                         B[i], targs[5])
    assert max_abs(S, S_scan) <= 1e-5 * S_scan.abs().max().item()


def test_ssd_decode_step_matches_jax_fp32():
    x, dt, A, B, C, D = _ssd_inputs(3, 1)
    S = np.random.default_rng(4).standard_normal((6, 8, 16)).astype(np.float32)
    wS, wy = jssm.ssd_decode_step(jnp.asarray(S), x[0], dt[0], A, B[0], C[0],
                                  D)
    gS, gy = tssm.ssd_decode_step(t(S), t(x[0]), t(dt[0]), t(A), t(B[0]),
                                  t(C[0]), t(D))
    assert max_abs(gS, wS) < 1e-5 and max_abs(gy, wy) < 1e-5


@pytest.mark.parametrize("chunked", [True, False])
def test_block_apply_and_block_decode_match_jax_fp32(chunked):
    """The narrower case's blocks (the smoke widths' run in the top-level
    tests under an fp32 policy)."""
    cfg, params, model = loaded("zamba2_narrow")
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    want = jax.jit(jax.vmap(lambda xx: jssm.block_apply(
        lp, cfg, xx, chunked=chunked)))(x)
    got = tssm.block_apply(model.layers[1], pcfg, t(x), chunked=chunked)
    assert max_abs(got, want) < 1e-5
    c = cfg.d_inner + 2 * cfg.ssm_state
    st = {"conv": rng.standard_normal((2, cfg.ssm_conv - 1, c)).astype(
              np.float32),
          "S": rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_state,
                                    cfg.ssm_head_dim)).astype(np.float32)}
    wy, wst = jax.jit(jax.vmap(lambda xx, c_, s_: jssm.block_decode(
        lp, cfg, xx, {"conv": c_, "S": s_})))(x[:, 0], st["conv"], st["S"])
    gy, gst = tssm.block_decode(model.layers[1], pcfg, t(x[:, 0]),
                                {k: t(v) for k, v in st.items()})
    assert max_abs(gy, wy) < 1e-5
    for key in ("conv", "S"):
        assert max_abs(gst[key], wst[key]) < 1e-5


def _port_run(cfg, model, tokens, steps, cache_dtype=torch.bfloat16):
    tm, pcfg = PORT[cfg.family], port_cfg(cfg)
    copy = lambda c: {k: v.clone() for k, v in c.items()}
    out = [tm.forward(model, pcfg, torch.as_tensor(tokens))]
    logits, cache = tm.prefill(model, pcfg, torch.as_tensor(tokens),
                               tm.init_cache(pcfg, tokens.shape[0], 24,
                                             cache_dtype, device="cpu"))
    out += [logits, copy(cache)]
    for tok in steps:
        logits, cache = tm.decode_step(model, pcfg, torch.as_tensor(tok),
                                       cache)
        out.append((logits, copy(cache)))
    return out


def _caches_close(got, want, want32, what):
    for key in want:
        if key == "length":
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        else:
            assert_bf16_close(got[key], want[key], f"{what} {key}",
                              want32[key])


def test_forward_prefill_and_decode_match_jax(setup, monkeypatch):
    """forward, prefill (13 tokens), then three decode steps: bf16 against
    the reference within the bf16 tolerance, caches included; under an fp32
    policy on both sides within 1e-5 of the largest |logit|, and the
    prefill's chunk-derived state S within 1e-4 max |S| of the reference's
    scanned one."""
    cfg, params, model = setup
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 13), dtype=np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
             for _ in range(3)]
    want, want32 = ref_serve_both(
        JAX[cfg.family], cfg, JAX[cfg.family].forward)(params, tokens, steps)
    got = _port_run(cfg, model, tokens, steps)
    assert got[0].dtype == torch.bfloat16
    assert got[0].shape == (2, 13, cfg.vocab)
    assert_bf16_close(got[0], want[0], "forward", want32[0])
    assert_bf16_close(got[1], want[1], "prefill logits", want32[1])
    assert set(got[2]) == set(want[2])
    _caches_close(got[2], want[2], want32[2], "prefill")
    for i in range(3):
        assert_bf16_close(got[3 + i][0], want[3 + i][0], f"decode {i}",
                          want32[3 + i][0])
        _caches_close(got[3 + i][1], want[3 + i][1], want32[3 + i][1],
                      f"decode {i}")
    monkeypatch.setattr(PORT[cfg.family], "BF16",
                        Policy(compute_dtype=torch.float32))
    got32 = _port_run(cfg, model, tokens, steps, torch.float32)
    scale = max(float(np.abs(np.asarray(want32[0])).max()), 1.0)
    for g, w in [(got32[0], want32[0]), (got32[1], want32[1])] + [
            (got32[3 + i][0], want32[3 + i][0]) for i in range(3)]:
        assert max_abs(g, w) < 1e-5 * scale
    S, S_ref = got32[2]["S"], want32[2]["S"]
    assert max_abs(S, S_ref) <= 1e-4 * float(np.abs(np.asarray(S_ref)).max())
    assert max_abs(got32[2]["conv"], want32[2]["conv"]) < 1e-5


def test_short_prompt_raises_instead_of_a_short_conv_history():
    """The reference's prefill keeps xbc[-(K-1):] of a prompt shorter than
    K - 1 = 3 tokens, which its cache cannot take; the port refuses it."""
    for name in ("mamba2_smoke", "zamba2_narrow"):
        cfg, _, model = loaded(name)
        tm, pcfg = PORT[cfg.family], port_cfg(cfg)
        with pytest.raises(ValueError, match="shorter than the convolution"):
            tm.prefill(model, pcfg, torch.zeros((1, 2), dtype=torch.int64),
                       tm.init_cache(pcfg, 1, 8, device="cpu"))


def test_hybrid_shared_block_schedule_and_invocation_caches(monkeypatch):
    """The shared block runs after layers 0, 2 and 4 of 5 (every 2), in
    forward and prefill alike; each invocation writes its own KV rows."""
    cfg = dataclasses.replace(CFGS["zamba2_narrow"](), n_layer=5)
    pcfg = port_cfg(cfg)
    assert thybrid.n_shared_invocations(pcfg) == \
        jhybrid.n_shared_invocations(cfg) == 3
    model = thybrid.init_params(pcfg, seed=2, device="cpu")
    calls = []
    real = thybrid.shared_block_apply

    def spy(p, c, x, x0, positions, **kw):
        calls.append(x0.shape)
        return real(p, c, x, x0, positions, **kw)
    monkeypatch.setattr(thybrid, "shared_block_apply", spy)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (1, 6)))
    thybrid.forward(model, pcfg, tokens)
    assert len(calls) == 3
    cache = thybrid.init_cache(pcfg, 1, 8, device="cpu")
    assert cache["shared_k"].shape == (3, 1, 8, cfg.n_kv_head, cfg.d_head)
    _, cache = thybrid.prefill(model, pcfg, tokens, cache)
    assert len(calls) == 6
    k = cache["shared_k"]
    assert bool((k[:, :, :6] != 0).any(-1).any(-1).all())   # every row
    assert not bool(k[:, :, 6:].any())
    assert not torch.equal(k[0], k[1]) and not torch.equal(k[1], k[2])
    thybrid.decode_step(model, pcfg, tokens[:, :1], cache)
    assert bool(cache["shared_v"][:, :, 6].any(-1).any(-1).all())


def test_hybrid_engine_logits_follow_the_jax_engines_token_stream():
    """Along each request's tokens from the JAX engine, the port's prefill
    and decode logits (teacher-forced) agree with JAX's within the
    bf16 tolerance (atol from the reference's fp32-policy run along the
    same tokens); the port's engine serves the same requests."""
    cfg, params, model = loaded("zamba2_narrow")
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (2, 13), dtype=np.int32)
    jengine = JaxDecodeEngine(jhybrid, cfg, params, batch_slots=2, max_len=24)
    stream = jengine.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])
    # both requests teacher-forced as one batch of 2 (the shapes, and so
    # the compiled steps, of test_forward_prefill_and_decode_match_jax)
    steps = [np.array([[stream[0][j]], [stream[1][j]]], np.int32)
             for j in range(3)]
    want, want32 = ref_serve_both(
        JAX[cfg.family], cfg, JAX[cfg.family].forward)(params, prompts, steps)
    got = _port_run(cfg, model, prompts, steps)
    assert_bf16_close(got[1], want[1], "prefill", want32[1])
    for j in range(3):
        assert_bf16_close(got[3 + j][0], want[3 + j][0], f"decode {j}",
                          want32[3 + j][0])
    pcfg = port_cfg(cfg)
    engine = DecodeEngine(get_model(pcfg), pcfg, model, batch_slots=2,
                          max_len=24, device="cpu")
    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=4)
                       for i, p in enumerate(prompts)])
    assert sorted(done) == [0, 1]
    assert all(len(v) == 4 and 0 <= min(v) and max(v) < cfg.vocab
               for v in done.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_attention_at_head_dim_112_matches_jax(dtype):
    """zamba2-7b's shared attention (head dim 3584 / 32 = 112) through
    ``attention(impl="pallas")``: on CPU tensors K6's plain version, against
    the reference's attention (its ``chunked`` path; its Pallas kernel does
    not run on this JAX), causal, GQA; fp32 within 1e-5, bf16 within the
    reference's bf16 kernel tolerance 3e-2."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((1, 40, 4, 112)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 2, 112)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                         causal=True, impl="chunked", chunk_size=16)
    got = attention(*(t(a, td) for a in (q, k, v)), causal=True,
                    impl="pallas")
    assert got.dtype == td and got.shape == (1, 40, 4, 112)
    if dtype == "float32":
        assert max_abs(got, want) < 1e-5
    else:
        assert_bf16_close(got, want, "attention D 112")
