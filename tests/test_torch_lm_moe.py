"""The port's MoE LM (``repro_torch.models.moe``, the serving half) and its
``DecodeEngine`` against the JAX package, on the CPU.

Weights come from the JAX init plus numpy noise, carried through ``bridge``
with the layer axis split (``LM_STACKED``); inputs are numpy arrays from a
seed.  Configs: ``get_smoke_config("qwen2-moe-a2.7b")`` (d 128, 4 experts in
64 bank slots, top 2, one shared expert, QKV bias) and a narrower case (d
48, 6 experts in 8 slots, head dim 12).  The port runs
``attention_impl="pallas"`` (K6's plain version on CPU tensors); the JAX side
its configs' ``chunked`` default.

Tolerances, as ``tests/test_torch_lm_model.py`` states them: fp32 within
1e-5 where the JAX function is policy-free (``router_topk``,
``moe_ffn_dense`` on fp32 inputs); at the reference's bf16 cast within atol
+ 2^-7 |JAX|, atol the larger of 3e-2 and twice the reference's own bf16 -
fp32 error on the same input.  Under an fp32 policy on both sides the
top-level functions agree within 1e-5 relative to the largest |logit|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest

from repro_torch import bridge
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.nn.layers import Policy
from repro_torch.serve.engine import DecodeEngine, Request

from test_torch_lm_model import (assert_bf16_close, port_cfg, ref_jit,
                                 ref_serve_both)
from torch_util import lm_tree, max_abs, t

CFGS = {
    "qwen2_moe_smoke": lambda: jax_smoke_config("qwen2-moe-a2.7b",
                                                scan_layers=True),
    "narrow": lambda: jax_smoke_config(
        "qwen2-moe-a2.7b", scan_layers=True, d_model=48, n_head=4,
        n_kv_head=2, d_head=12, vocab=61, n_experts=6, top_k=2,
        expert_pad_to=8, moe_d_ff=32, shared_d_ff=40, attention_chunk=16),
}


@functools.lru_cache(maxsize=None)
def loaded(name: str):
    """(config, JAX params (numpy), the port's model loaded with them)."""
    cfg = CFGS[name]()
    model = tmoe.init_params(port_cfg(cfg), device="cpu")
    params = lm_tree(model, cfg, 1)
    bridge.load_jax_params(model, params, stacked=bridge.LM_STACKED)
    return cfg, params, model


@pytest.fixture(params=sorted(CFGS))
def setup(request):
    return loaded(request.param)


def test_init_params_keys_shapes_and_padded_banks(setup):
    """The reference's keys and shapes (``jax.eval_shape`` of its init),
    the bank's spread against one reference layer's (jitted alone: the
    whole init's compile takes 3-4 s), the bridge's round trip."""
    cfg = setup[0]
    shapes = jax.eval_shape(lambda k: jmoe.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in bridge.flatten(shapes).items()}
    model = tmoe.init_params(port_cfg(cfg), seed=0, device="cpu")
    got = model.state_dict()
    flat = bridge.flatten(bridge.state_dict_to_params(
        got, stacked=bridge.LM_STACKED))
    assert set(flat) == set(want)
    for key, w in want.items():
        assert flat[key].shape == w, key
    e_pad = jmoe.padded_experts(cfg)
    assert tmoe.padded_experts(port_cfg(cfg)) == e_pad > cfg.n_experts
    bank = got["layers.0.moe.w_gate"]
    assert bank.shape == (e_pad, cfg.d_model, cfg.moe_d_ff)
    # lecun truncated normal over the bank's fan-in (d), like the reference's
    ref = jax.jit(lambda k: jmoe.moe_ffn_init(k, cfg))(
        jax.random.PRNGKey(0))["w_gate"]
    assert abs(bank.std().item() / float(jnp.std(ref)) - 1) < 0.15
    assert got["layers.0.moe.router.w"].shape == (cfg.d_model, cfg.n_experts)
    # the bridge's round trip restores the reference's stacked banks
    _, params, loaded_model = setup
    back = bridge.state_dict_to_params(loaded_model.state_dict(),
                                       stacked=bridge.LM_STACKED)
    assert back["layers"]["moe"]["w_gate"].shape == (
        cfg.n_layer, e_pad, cfg.d_model, cfg.moe_d_ff)
    for key, leaf in bridge.flatten(params).items():
        np.testing.assert_array_equal(bridge.flatten(back)[key], leaf)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_router_topk_ties_choose_the_references_experts(k):
    """bf16 logits with ties at the k-th place: equal fp32 probabilities,
    where the reference's ``jax.lax.top_k`` keeps the lower expert index."""
    rng = np.random.default_rng(k)
    levels = np.array([0.5, 0.25, 0.0, -0.25, 1.0], np.float32)
    logits = levels[rng.integers(0, len(levels), (64, 8))]
    logits[0] = [0.5, 1.0, 0.5, 0.5, 0.0, 0.5, 1.0, 0.5]    # ties across k
    logits[1] = 0.25                                       # all equal
    lb = jnp.asarray(logits, jnp.bfloat16)
    want_g, want_i, want_p = jmoe.router_topk(lb, k)
    got_g, got_i, got_p = tmoe.router_topk(
        t(np.asarray(lb, np.float32), torch.bfloat16), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert max_abs(got_g, want_g) < 1e-6 and max_abs(got_p, want_p) < 1e-6
    # all eight tie: the first k experts
    np.testing.assert_array_equal(got_i[1].numpy(), np.arange(k))


def test_moe_ffn_dense_matches_jax_fp32(setup):
    cfg, params, model = setup
    x = np.random.default_rng(2).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    want = jax.jit(lambda p, x: jmoe.moe_ffn_dense(p, cfg, x))(lp["moe"], x)
    got = tmoe.moe_ffn_dense(model.layers[0].moe, port_cfg(cfg), t(x))
    assert got.dtype == torch.float32
    assert max_abs(got, want) < 1e-5


def test_capacity_routed_moe_ffn_matches_the_reference(setup):
    """The first layer's capacity-routed ``moe_ffn`` with the router loss,
    on fp32 inputs, against the reference's (within 1e-5 of the largest |output|, the loss
    within 1e-6); ``tests/test_torch_lm_train.py`` holds the whole
    ``forward(dropless=False)`` through each family's loss."""
    cfg, params, model = setup
    x = np.random.default_rng(3).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn(
        p, cfg, x, return_aux=True))(lp["moe"], x)
    got, aux = tmoe.moe_ffn(model.layers[0].moe, port_cfg(cfg), t(x),
                            return_aux=True)
    scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
    assert max_abs(got, want) < 1e-5 * scale
    assert abs(aux.item() - float(want_aux)) < 1e-6


def _dropless_forward(params, cfg, tokens):
    return jmoe.forward(params, cfg, tokens, dropless=True)[0]


def _port_run(cfg, model, tokens, steps, cache_dtype=torch.bfloat16):
    pcfg = port_cfg(cfg)
    out = [tmoe.forward(model, pcfg, torch.as_tensor(tokens),
                        dropless=True)[0]]
    logits, cache = tmoe.prefill(model, pcfg, torch.as_tensor(tokens),
                                 tmoe.init_cache(pcfg, tokens.shape[0], 24,
                                                 cache_dtype, device="cpu"))
    out += [logits, {k: v.clone() for k, v in cache.items()}]
    for tok in steps:
        logits, cache = tmoe.decode_step(model, pcfg, torch.as_tensor(tok),
                                         cache)
        out.append((logits, {k: v.clone() for k, v in cache.items()}))
    return out


def test_forward_prefill_and_decode_match_jax(setup, monkeypatch):
    """forward (dropless), prefill, then three decode steps: bf16 against
    the reference within the bf16 tolerance, and under an fp32 policy on both sides within 1e-5 of the
    largest |logit|."""
    cfg, params, model = setup
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 11), dtype=np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
             for _ in range(3)]
    want, want32 = ref_serve_both(jmoe, cfg, _dropless_forward)(
        params, tokens, steps)
    got = _port_run(cfg, model, tokens, steps)
    assert got[0].dtype == torch.bfloat16
    assert got[0].shape == (2, 11, cfg.vocab)
    assert_bf16_close(got[0], want[0], "forward", want32[0])
    assert_bf16_close(got[1], want[1], "prefill logits", want32[1])
    for key in ("k", "v"):
        assert_bf16_close(got[2][key], want[2][key], f"prefill {key}",
                          want32[2][key])
    for i in range(3):
        (gl, gc), (wl, wc), (wl32, wc32) = got[3 + i], want[3 + i], \
            want32[3 + i]
        assert_bf16_close(gl, wl, f"decode {i} logits", wl32)
        for key in ("k", "v"):
            assert_bf16_close(gc[key], wc[key], f"decode {i} {key}",
                              wc32[key])
        np.testing.assert_array_equal(gc["length"].numpy(),
                                      np.asarray(wc["length"]))
    monkeypatch.setattr(tmoe, "BF16", Policy(compute_dtype=torch.float32))
    got32 = _port_run(cfg, model, tokens, steps, torch.float32)
    scale = max(float(np.abs(np.asarray(want32[0])).max()), 1.0)
    assert max_abs(got32[0], want32[0]) < 1e-5 * scale
    assert max_abs(got32[1], want32[1]) < 1e-5 * scale
    for i in range(3):
        assert max_abs(got32[3 + i][0], want32[3 + i][0]) < 1e-5 * scale


def test_engine_logits_follow_the_jax_engines_token_stream():
    """Along each request's tokens from the JAX engine, the port's prefill
    and decode logits (teacher-forced) agree with JAX's within the
    bf16 tolerance (its atol from the reference's fp32-policy run along the
    same tokens); then the port's engine serves the same requests, every
    token in the vocabulary."""
    cfg, params, model = loaded("narrow")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, (2, 11), dtype=np.int32)
    jengine = JaxDecodeEngine(jmoe, cfg, params, batch_slots=2, max_len=24)
    stream = jengine.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])
    # both requests teacher-forced as one batch of 2 (the shapes, and so
    # the compiled steps, of test_forward_prefill_and_decode_match_jax)
    steps = [np.array([[stream[0][j]], [stream[1][j]]], np.int32)
             for j in range(3)]
    want, want32 = ref_serve_both(jmoe, cfg, _dropless_forward)(
        params, prompts, steps)
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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_port_config_is_the_references(arch):
    from repro_torch import configs
    assert dataclasses.asdict(configs.get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    cfg = configs.get_config("qwen2-moe-a2.7b")
    assert (cfg.n_layer, cfg.d_model, cfg.n_experts, cfg.top_k,
            cfg.expert_pad_to, cfg.n_shared_experts) == (24, 2048, 60, 4, 64, 4)
