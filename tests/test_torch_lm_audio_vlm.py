"""The port's Whisper encoder-decoder (``repro_torch.models.whisper``) and
InternVL2-style VLM (``repro_torch.models.vlm``) serving and forward
functions against the JAX package, on the CPU.

Weights: the port's own init plus numpy noise (``randomize_np``), carried
into the reference's layout through ``bridge`` (whisper's ``enc_layers`` /
``dec_layers`` and the VLM's ``layers`` stacked under ``scan_layers``, one
dict per layer without it); the reference's shapes come from
``jax.eval_shape`` of its ``init_params``.  Inputs are numpy arrays from a
seed.  Configs: each arch's ``get_smoke_config`` (whisper: 2 + 2 layers, d
128, 4 heads over 2 KV heads, 8 frames of 64 features, so ``frame_proj``
exists; internvl2: 2 layers, d 128, 8 patches of 64 features), and a
whisper whose frames are already d_model wide (no ``frame_proj``) with
its layers unstacked.  The port runs ``attention_impl="pallas"`` (K6's
plain version on CPU tensors); the JAX side its configs' ``chunked``.
Each reference function is jitted once per test, under both policies
in one jit where both are compared (``jax_both``).

Tolerances, as ``tests/test_torch_lm_model.py`` states them: fp32 within
1e-4 where the JAX function is policy-free (``encode``, ``gelu_mlp``,
``project_patches`` on fp32 weights); at the reference's bf16 cast within
atol + 2^-7 |JAX|, atol the larger of 3e-2 and twice the reference's own
bf16 - fp32 error on the same input (at these widths its bf16 logits lie
up to 0.05 from its fp32 ones); under an fp32 policy on both sides within
1e-4 of the largest |logit|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import vlm as jvlm
from repro.models import whisper as jwhisper
from repro.nn import layers as jlayers

from repro_torch import bridge
from repro_torch.models import get_model
from repro_torch.models import dense as tdense
from repro_torch.models import vlm as tvlm
from repro_torch.models import whisper as twhisper
from repro_torch.nn import layers as tlayers

from test_torch_lm_model import (assert_bf16_close, jax_fp32_policy,
                                 port_cfg, ref_jit, ref_serve_both)
from torch_util import fast_jit, listed, lm_tree, max_abs, t

CFGS = {
    "whisper": lambda: jax_smoke_config("whisper-medium", scan_layers=True),
    # frames at d_model (no frame_proj), layers unstacked
    "whisper_unstacked": lambda: jax_smoke_config(
        "whisper-medium", frontend_dim=128, n_layer=1),
    "internvl2": lambda: jax_smoke_config("internvl2-26b", scan_layers=True),
    "internvl2_unstacked": lambda: jax_smoke_config("internvl2-26b"),
}
JAX = {"audio": jwhisper, "vlm": jvlm}
PORT = {"audio": twhisper, "vlm": tvlm}
MAX_LEN = 24


def stacked(cfg):
    return bridge.LM_STACKED if cfg.scan_layers else ()


@functools.lru_cache(maxsize=None)
def loaded(name: str):
    """(config, the reference's params (numpy), the port's model loaded
    with them)."""
    cfg = CFGS[name]()
    model = PORT[cfg.family].init_params(port_cfg(cfg), seed=0, device="cpu")
    params = lm_tree(model, cfg, 1)
    bridge.load_jax_params(model, params, stacked=stacked(cfg))
    return cfg, params, model


@pytest.fixture(params=sorted(CFGS))
def setup(request):
    return loaded(request.param)


def _inputs(cfg, seed: int, b: int = 2, s: int = 9):
    rng = np.random.default_rng(seed)
    key = "frames" if cfg.family == "audio" else "patches"
    return {key: rng.standard_normal((b, cfg.n_frontend_tokens,
                                      cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_init_params_keys_shapes_and_bridge_round_trip(setup):
    """The port's init has the reference's keys and shapes (``frame_proj``
    only where the frames are not d_model wide); norms start at ones and
    zeros; the loaded model goes back to the reference's tree unchanged."""
    cfg, params, model = setup
    jm = JAX[cfg.family]
    want = bridge.flatten(jax.eval_shape(lambda k: jm.init_params(k, cfg),
                                         jax.random.PRNGKey(0)))
    fresh = PORT[cfg.family].init_params(port_cfg(cfg), seed=0, device="cpu")
    got = bridge.flatten(listed(bridge.state_dict_to_params(
        fresh.state_dict(), stacked=stacked(cfg))))
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        if ".ln" in key or key.startswith(("enc_ln", "dec_ln", "ln_f")):
            assert (got[key] == (0 if key.endswith("bias") else 1)).all(), key
    assert ("frame_proj.w" in got) == (cfg.family == "audio"
                                       and cfg.frontend_dim != cfg.d_model)
    if cfg.family == "audio":   # wk / xk have no bias
        assert not any(k.endswith(("wk.b", "xk.b")) for k in got)
    back = bridge.flatten(listed(bridge.state_dict_to_params(
        model.state_dict(), stacked=stacked(cfg))))
    flat = bridge.flatten(params)
    assert set(back) == set(flat)
    for key, leaf in flat.items():
        np.testing.assert_array_equal(back[key], leaf)
    assert get_model(port_cfg(cfg)) is PORT[cfg.family]


F32 = tlayers.Policy(compute_dtype=torch.float32)


def fp32_policy(monkeypatch, cfg):
    """The port's casts at fp32 (the family's module and dense's, whose
    decode step the VLM's is)."""
    monkeypatch.setattr(PORT[cfg.family], "BF16", F32)
    monkeypatch.setattr(tdense, "BF16", F32)


def jax_both(fn):
    """``fn`` of the reference as it is (bf16) and under an fp32 policy, in
    one jit: one compile, ~30% less than two."""
    def both(*args):
        out = fn(*args)
        with jax_fp32_policy():
            return out, fn(*args)
    return fast_jit(both)


def close32(got, want, scale):
    assert max_abs(got, want) < 1e-4 * max(scale, 1.0)


def test_forward_matches_jax(setup, monkeypatch):
    """bf16 against the reference; both under an fp32 policy."""
    cfg, params, model = setup
    batch = _inputs(cfg, 2)
    jm = JAX[cfg.family]
    want, want32 = jax_both(lambda p, b: jm.forward(p, cfg, b))(params, batch)
    got = PORT[cfg.family].forward(model, port_cfg(cfg), _port_batch(batch))
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 9, cfg.vocab)
    assert_bf16_close(got, want, "forward", want32)
    fp32_policy(monkeypatch, cfg)
    got32 = PORT[cfg.family].forward(model, port_cfg(cfg), _port_batch(batch))
    scale = float(np.abs(np.asarray(want32)).max())
    if cfg.family == "audio" and cfg.frontend_dim == cfg.d_model:
        # no frame_proj: the encoder's input stays bf16 under either
        # policy, frames + the position table cast to bf16, and the two
        # libraries' fp32 tables (pow, sin) round 1 bf16 ulp apart at a
        # few entries (44 of whisper-medium's 1500 x 1024)
        assert max_abs(got32, want32) < 2e-3 * scale
    else:
        close32(got32, want32, scale)


@pytest.mark.parametrize("name", ["whisper", "whisper_unstacked"])
def test_encode_matches_jax_fp32(name):
    """The encoder on the fp32 weights (policy-free), with and without
    ``frame_proj``."""
    cfg, params, model = loaded(name)
    frames = _inputs(cfg, 3)["frames"]
    want = ref_jit(jwhisper.encode, cfg)(params, frames)
    got = twhisper.encode(model, port_cfg(cfg), t(frames))
    assert got.dtype == torch.float32
    assert max_abs(got, want) < 1e-4


def test_gelu_mlp_and_projector_are_tanh_gelu_fp32():
    """``gelu_mlp`` and the VLM's projector match the reference's
    ``jax.nn.gelu`` (the tanh form) within 1e-4; the erf form, torch's
    default, misses by more than 5e-4."""
    cfg, params, model = loaded("internvl2")
    x = 3 * np.random.default_rng(4).standard_normal(
        (2, 5, cfg.frontend_dim)).astype(np.float32)
    want = jax.jit(jvlm.project_patches)(params, x)
    assert max_abs(tvlm.project_patches(model, t(x)), want) < 1e-4
    wcfg, wparams, wmodel = loaded("whisper")
    mlp = jax.tree_util.tree_map(lambda a: a[0], wparams["enc_layers"]["mlp"])
    h = 3 * np.random.default_rng(5).standard_normal(
        (2, 5, wcfg.d_model)).astype(np.float32)
    want = jax.jit(jlayers.gelu_mlp)(mlp, h)
    p = wmodel.enc_layers[0].mlp
    assert max_abs(tlayers.gelu_mlp(p, t(h)), want) < 1e-4
    erf = tlayers.dense(p.w_out, F.gelu(tlayers.dense(p.w_in, t(h))))
    assert max_abs(erf, want) > 5e-4


def _caches_close(got, want, want32, what):
    for key, w in want.items():
        if key == "length":
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))
        else:
            assert_bf16_close(got[key], w, f"{what} {key}", want32[key])


def _port_serve(cfg, model, batch, steps, dtype):
    """The port's ``_jax_serve`` (the caller sets the policy)."""
    tm, pcfg = PORT[cfg.family], port_cfg(cfg)
    out = [tm.prefill(model, pcfg, _port_batch(batch),
                      tm.init_cache(pcfg, 2, MAX_LEN, dtype, device="cpu"))]
    for tok1 in steps:
        # the port writes the cache in place: step a copy
        cache = {k: v.clone() for k, v in out[-1][1].items()}
        out.append(tm.decode_step(model, pcfg, torch.as_tensor(tok1), cache))
    return out


@pytest.mark.parametrize("name", ["whisper", "internvl2"])
def test_prefill_and_decode_steps_match_jax(name, monkeypatch):
    """A batched prefill (whisper: the frames and a 9-token prompt of which
    only the first is read; internvl2: the patches and a 9-token prompt),
    then two decode steps: bf16 against the reference, caches included;
    both under an fp32 policy."""
    cfg, params, model = loaded(name)
    batch = _inputs(cfg, 6)
    rng = np.random.default_rng(7)
    steps = [rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
             for _ in range(2)]
    # [(prefill logits, cache), then (logits, cache) per step], both policies
    want, want32 = ([tuple(out[:2]), *out[2:]] for out in ref_serve_both(
        JAX[cfg.family], cfg, max_len=MAX_LEN)(params, batch, steps))
    got = _port_serve(cfg, model, batch, steps, torch.bfloat16)
    if cfg.family == "audio":   # the prompt after its first token is unread
        other = dict(batch, tokens=batch["tokens"][:, :1])
        again, _ = twhisper.prefill(
            model, port_cfg(cfg), _port_batch(other),
            twhisper.init_cache(port_cfg(cfg), 2, MAX_LEN, device="cpu"))
        assert torch.equal(again, got[0][0])
    fp32_policy(monkeypatch, cfg)
    got32 = _port_serve(cfg, model, batch, steps, torch.float32)
    for i, ((g, gc), (w, wc), (w32, wc32)) in enumerate(zip(got, want,
                                                            want32)):
        assert g.shape == (2, 1, cfg.vocab)
        assert_bf16_close(g, w, f"step {i} logits", w32)
        _caches_close(gc, wc, wc32, f"step {i} cache")
    scale = max(float(np.abs(np.asarray(w)).max()) for w, _ in want32)
    for (g, gc), (w, wc) in zip(got32, want32):
        close32(g, w, scale)
        for key in ("k", "v"):
            close32(gc[key], wc[key], float(np.abs(np.asarray(wc[key])).max()))


@pytest.mark.parametrize("lengths", [(5, 2), (9000, 3)])
def test_whisper_decode_position_is_slot_0s(lengths, monkeypatch):
    """Slots at unequal lengths, under an fp32 policy on both sides: every
    slot takes the position embedding of slot 0's length, as the
    reference's decode step does; at 9000 the position clamps to the
    table's last row (8191) and the cache write to the cache's last slot,
    as JAX's gather and dynamic_update_slice do."""
    cfg, params, model = loaded("whisper")
    fp32_policy(monkeypatch, cfg)
    rng = np.random.default_rng(8)
    kv = (cfg.n_layer, 2, MAX_LEN, cfg.n_kv_head, cfg.d_head)
    xkv = (cfg.n_layer, 2, cfg.n_frontend_tokens, cfg.n_kv_head, cfg.d_head)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("k", kv), ("v", kv), ("xk", xkv), ("xv", xkv))}
    jc = {k: jnp.asarray(v) for k, v in arrays.items()}
    tc = {k: t(v) for k, v in arrays.items()}
    jc["length"] = jnp.asarray(lengths, jnp.int32)
    tc["length"] = torch.as_tensor(lengths, dtype=torch.int32)
    tok1 = rng.integers(0, cfg.vocab, (2, 1), dtype=np.int32)
    want, jc = ref_jit(jwhisper.decode_step, cfg, True)(params, tok1, jc)
    got, tc = twhisper.decode_step(model, port_cfg(cfg),
                                   torch.as_tensor(tok1), tc)
    close32(got, want, float(np.abs(np.asarray(want)).max()))
    for key in ("k", "v"):
        assert max_abs(tc[key], jc[key]) < 1e-5
    row = twhisper.position_embedding(port_cfg(cfg), tc["length"] - 1,
                                      torch.float32)
    table = twhisper._sinusoid(twhisper.MAX_POSITIONS, cfg.d_model,
                               torch.float32)
    assert torch.equal(row[0, 0], table[min(lengths[0], 8191)])
