"""The port's dense LM (``repro_torch.models.dense``) and ``DecodeEngine``
against the JAX package, on the CPU.

Weights come from the port's init plus numpy noise (``lm_tree``; the init
test holds the port's init to the JAX init's keys, shapes and spread) and
go through ``bridge`` with the layer axis split (``stacked=("layers",)``)
where the config scans its layers; inputs are numpy
arrays from a seed.  Configs: ``tests/test_serve.py::_cfg`` (2 layers, d 48,
4 heads, 2 KV heads, vocab 61) and ``get_smoke_config("glm4-9b")`` (d 128,
d_head 32, QKV bias).  The port runs ``attention_impl="pallas"`` (K6's plain
version on CPU tensors); the JAX side its configs' ``chunked`` default.

Tolerances: the layer stack at fp32 within 1e-5 (the JAX function is
policy-free).  The top-level functions at the reference's bf16 cast: within
atol + 2^-7 |JAX| (one bf16 ulp relative: JAX and torch round bf16 at other
places), atol the reference's bf16 kernel tolerance 3e-2, or twice the
reference's own bf16 error on the same input where that is larger: the
largest |JAX bf16 - JAX fp32| (the same function run under an fp32 policy).
Two bf16 evaluations that each lie within E of the fp32 value lie within 2E
of each other; at the glm4-9b smoke width the reference's own bf16 logits
lie 0.051 from its fp32 ones, over the 3e-2.  The engine's token-stream test
keeps 3e-2.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import dense as jdense
from repro.models.lmconfig import LMConfig as JaxLMConfig
from repro.nn import layers as jax_layers
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest

from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import dense as tdense
from repro_torch.models import get_model
from repro_torch.models.lmconfig import LMConfig, with_kernels
from repro_torch.serve.engine import DecodeEngine, Request

from torch_util import fast_jit, lm_tree, max_abs, np_tree, t


def _cfg(**kw):
    return JaxLMConfig(arch_id="t", family="dense", n_layer=2, d_model=48,
                       n_head=4, n_kv_head=2, d_ff=96, vocab=61,
                       scan_layers=True, remat="none", attention_chunk=16,
                       **kw)


CFGS = {"serve_cfg": _cfg, "glm4_9b_smoke": lambda **kw: jax_smoke_config(
    "glm4-9b", **kw)}


def port_cfg(cfg: JaxLMConfig) -> LMConfig:
    return with_kernels(LMConfig(**dataclasses.asdict(cfg)))


@functools.lru_cache(maxsize=None)
def ref_jit(fn, cfg, f32: bool = False):
    """The reference's ``fn(params, cfg, *args)`` under ``fast_jit``, built
    once per (function, config, policy) for the module: jit compiles
    dominate these tests' time.  ``f32``: traced and run under an fp32 policy."""
    jitted = fast_jit(lambda p, *a: fn(p, cfg, *a))
    if not f32:
        return jitted

    def call(*args):
        with jax_fp32_policy():
            return jitted(*args)
    return call


@functools.lru_cache(maxsize=None)
def ref_both(fn, cfg):
    """``fn(params, cfg, *args)`` of the reference as it is (bf16) and
    under an fp32 policy, traced into one jit (one compile, ~30% less than
    two): ``ref_both(fn, cfg)(params, args, args32) -> (out, out32)``."""
    def both(params, args, args32):
        out = fn(params, cfg, *args)
        with jax_fp32_policy():
            return out, fn(params, cfg, *args32)
    return fast_jit(both)


@functools.lru_cache(maxsize=None)
def ref_serve_both(jm, cfg, forward=None, max_len: int = 24):
    """The reference family ``jm``'s serving sequence in one jit, at bf16
    (bf16 caches) and under an fp32 policy (fp32 caches): ``(params,
    inputs, steps) -> (out, out32)``, each ``[forward(params, cfg, inputs)
    (when ``forward`` is given), prefill logits, its cache, then (logits,
    cache) per decode step]``; ``steps`` is a list of (B, 1) tokens, which
    the decode steps take through one ``lax.scan`` (the step compiles
    once)."""
    def seq(dtype):
        def run(params, inputs, steps):
            head = [] if forward is None else [forward(params, cfg, inputs)]
            logits, cache = jm.prefill(params, cfg, inputs, jm.init_cache(
                cfg, steps.shape[1], max_len, dtype))

            def step(c, tok):
                lg, c = jm.decode_step(params, cfg, tok, c)
                return c, (lg, c)
            _, per_step = jax.lax.scan(step, cache, steps)
            return head + [logits, cache], per_step
        return run
    bf16, f32 = seq(jnp.bfloat16), seq(jnp.float32)

    def both(params, inputs, steps):
        out = bf16(params, inputs, steps)
        with jax_fp32_policy():
            return out, f32(params, inputs, steps)
    jitted = fast_jit(both)

    def call(params, inputs, steps):
        return tuple(head + [jax.tree_util.tree_map(lambda a: a[i], per_step)
                             for i in range(len(steps))]
                     for head, per_step in jitted(params, inputs,
                                                  np.stack(steps)))
    return call


def jax_init(cfg, seed: int):
    return np_tree(ref_jit(jdense.init_params, cfg)(jax.random.PRNGKey(seed)))


def jax_params(cfg, seed: int):
    return lm_tree(tdense.init_params(port_cfg(cfg), seed=seed, device="cpu"),
                   cfg, seed)


def port_model(cfg, params):
    model = tdense.DenseLM(port_cfg(cfg), device="cpu")
    stacked = bridge.LM_STACKED if cfg.scan_layers else ()
    return bridge.load_jax_params(model, params, stacked=stacked)


def assert_bf16_close(got, want, what="", want_f32=None):
    """|got - want| <= atol + 2^-7 |want|, atol = max(3e-2, 2 max|want -
    want_f32|) (3e-2 without ``want_f32``)."""
    f32 = lambda x: t(np.asarray(x, np.float32))
    g, w = got.float(), f32(want)
    atol = 3e-2
    if want_f32 is not None:
        atol = max(atol, 2 * (w - f32(want_f32)).abs().max().item())
    excess = ((g - w).abs() - atol - 2.0 ** -7 * w.abs()).max().item()
    assert excess <= 0, (f"{what}: max |diff| {(g - w).abs().max().item()} "
                         f"(atol {atol})")


@contextlib.contextmanager
def jax_fp32_policy():
    """The reference's functions with their bf16 cast replaced by fp32 (the
    cast is ``repro.nn.layers.BF16``, looked up at trace time)."""
    saved = jax_layers.BF16
    jax_layers.BF16 = jax_layers.F32
    try:
        yield
    finally:
        jax_layers.BF16 = saved


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_keys_shapes_and_statistics(name):
    cfg = CFGS[name]()
    want = bridge.params_to_state_dict(
        jax_init(cfg, 0), stacked=bridge.LM_STACKED if cfg.scan_layers else ())
    model = tdense.init_params(port_cfg(cfg), seed=0, device="cpu")
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == torch.float32, key
        if w.std() == 0:                   # norms (ones) and biases (zeros)
            assert torch.equal(g, w), key
            continue
        # lecun truncated normal / embedding normal: same spread and centre
        assert abs(g.std().item() / w.std().item() - 1) < 0.15, key
        assert abs(g.mean().item()) < 5 * w.std().item() / g.numel() ** 0.5, key
    bf = tdense.init_params(port_cfg(cfg), seed=0, device="cpu",
                            dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    assert torch.equal(bf.layers[0].wq.w, got["layers.0.wq.w"].bfloat16())


@pytest.mark.parametrize("parallel_block", [False, True])
def test_backbone_matches_jax_fp32(parallel_block):
    cfg = _cfg(parallel_block=parallel_block)
    params = jax_params(cfg, 1)
    model = port_model(cfg, params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    want = ref_jit(jdense.backbone, cfg)(params, jnp.asarray(x),
                                         jnp.asarray(pos))
    got = tdense.backbone(model, port_cfg(cfg), t(x), torch.as_tensor(pos))
    assert max_abs(got, want) < 1e-5


def _caches_close(got, want, want_f32, what):
    for key in ("k", "v"):
        assert_bf16_close(got[key], want[key], f"{what} {key}", want_f32[key])
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))


def _both(fn, cfg, params, *args32):
    """``fn(params, cfg, *args)`` of the reference as it is (bf16) and
    under an fp32 policy, in one jit (``ref_both``); each arg is a
    (bf16-side, fp32-side) pair."""
    return ref_both(fn, cfg)(params, tuple(a[0] for a in args32),
                             tuple(a[1] for a in args32))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_and_prefill_match_jax_bf16(name):
    cfg = CFGS[name]()
    pcfg = port_cfg(cfg)
    params = jax_params(cfg, 3)
    model = port_model(cfg, params)
    b, s, max_len = 2, 9, 16
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)
    want, want32 = _both(jdense.forward, cfg, params, (tokens, tokens))
    got = tdense.forward(model, pcfg, torch.as_tensor(tokens))
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, cfg.vocab)
    assert_bf16_close(got, want, "forward", want32)

    (want, jc), (want32, jc32) = _both(
        jdense.prefill, cfg, params, (tokens, tokens),
        (jdense.init_cache(cfg, b, max_len),
         jdense.init_cache(cfg, b, max_len, jnp.float32)))
    tcache = tdense.init_cache(pcfg, b, max_len, device="cpu")
    got, tcache = tdense.prefill(model, pcfg, torch.as_tensor(tokens), tcache)
    assert got.shape == (b, 1, cfg.vocab)
    assert_bf16_close(got, want, "prefill logits", want32)
    _caches_close(tcache, jc, jc32, "prefill cache")


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_steps_match_jax_bf16(name, uniform):
    """Three decode steps from a filled cache: at one length for every
    sequence (``uniform_decode``), or at ragged lengths (each sequence
    writes its own slot)."""
    cfg = CFGS[name](uniform_decode=uniform)
    pcfg = port_cfg(cfg)
    params = jax_params(cfg, 5)
    model = port_model(cfg, params)
    rng = np.random.default_rng(6)
    b, max_len = 2, 16
    shape = (cfg.n_layer, b, max_len, cfg.n_kv_head, cfg.d_head)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    lengths = np.array([9, 9] if uniform else [9, 5], np.int32)
    jc = {"k": jnp.asarray(kv[0], jnp.bfloat16),
          "v": jnp.asarray(kv[1], jnp.bfloat16), "length": jnp.asarray(lengths)}
    jc32 = {"k": jnp.asarray(jc["k"], jnp.float32),
            "v": jnp.asarray(jc["v"], jnp.float32), "length": jc["length"]}
    tc = {"k": t(kv[0], torch.bfloat16), "v": t(kv[1], torch.bfloat16),
          "length": torch.as_tensor(lengths)}
    step = ref_both(jdense.decode_step, cfg)
    for _ in range(3):
        tok1 = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
        (want, jc), (want32, jc32) = step(params, (tok1, jc), (tok1, jc32))
        got, tc = tdense.decode_step(model, pcfg, torch.as_tensor(tok1), tc)
        assert got.shape == (b, 1, cfg.vocab)
        assert_bf16_close(got, want, "decode logits", want32)
        _caches_close(tc, jc, jc32, "decode cache")


@pytest.mark.parametrize("uniform", [True, False])
def test_write_kv_cache_clamps_like_dynamic_update_slice(uniform):
    """A write at a length past the end of the cache lands on the last slot
    (the reference's ``dynamic_update_slice`` clamps and does not raise)."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((2, 6, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    for lengths in ([9, 9], [9, 2], [6, 0], [3, 5]):
        lengths = np.array(lengths, np.int32)
        want = jdense.write_kv_cache(jnp.asarray(c), jnp.asarray(new),
                                     jnp.asarray(lengths), uniform=uniform)
        got = tdense.write_kv_cache(t(c), t(new), torch.as_tensor(lengths),
                                    uniform=uniform)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _greedy_reference(pcfg, model, prompt, n_new):
    """Generate by full recompute (no cache), as tests/test_serve.py does."""
    toks, out = list(map(int, prompt)), []
    for _ in range(n_new):
        logits = tdense.forward(model, pcfg, torch.as_tensor([toks]))
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


def test_engine_matches_no_cache_reference():
    pcfg = port_cfg(_cfg())
    model = tdense.init_params(pcfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pcfg.vocab, 6, dtype=np.int32) for _ in range(3)]
    engine = DecodeEngine(get_model(pcfg), pcfg, model, batch_slots=2,
                          max_len=32, device="cpu")
    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=5)
                       for i, p in enumerate(prompts)])
    assert set(done) == {0, 1, 2}
    for i, p in enumerate(prompts):
        expect = _greedy_reference(pcfg, engine.params, p, 5)
        assert done[i] == expect, f"req {i}: {done[i]} != {expect}"


def test_engine_slot_reuse_and_stats():
    """More requests than slots: all finish, cache slots recycled."""
    pcfg = port_cfg(_cfg())
    model = tdense.init_params(pcfg, seed=1, device="cpu")
    assert model.layers[0].wq.w.dtype == torch.float32
    rng = np.random.default_rng(1)
    engine = DecodeEngine(get_model(pcfg), pcfg, model, batch_slots=2,
                          max_len=32, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in engine.params.parameters())
    reqs = [Request(rid=i, prompt=rng.integers(0, pcfg.vocab, 4 + i,
                                               dtype=np.int32),
                    max_new_tokens=3) for i in range(5)]
    done = engine.run(reqs)
    assert set(done) == set(range(5))
    assert all(len(v) == 3 for v in done.values())
    st = engine.last_stats
    assert [p["prompt_len"] for p in st["prefill"]] == [4, 5, 6, 7, 8]
    assert sum(st["decode_tokens"]) == 5 * 2
    assert len(st["decode_step_s"]) == len(st["decode_tokens"])


def test_engine_logits_follow_the_jax_engines_token_stream():
    """Along each request's tokens from the JAX engine, the port's prefill
    and decode logits (batch 1, teacher-forced) agree with JAX's.  Logits,
    not tokens: JAX and torch round bf16 apart, so argmax may flip on a
    near-tie."""
    cfg = _cfg()
    pcfg = port_cfg(cfg)
    params = jax_params(cfg, 6)
    model = port_model(cfg, params)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (5, 8, 3)]
    jengine = JaxDecodeEngine(jdense, cfg, params, batch_slots=2, max_len=24)
    stream = jengine.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])
    jstep = ref_jit(jdense.decode_step, cfg)
    tparams = tdense.BF16.cast(model)
    for i, p in enumerate(prompts):
        # the engine's own jitted batch-1 prefill (compiled per prompt length)
        want, jc = jengine._prefill1(params, p[None], jdense.init_cache(cfg, 1, 24))
        got, tc = tdense.prefill(tparams, pcfg, torch.as_tensor(p[None]),
                                 tdense.init_cache(pcfg, 1, 24, device="cpu"))
        assert_bf16_close(got, want, f"req {i} prefill")
        for tok in stream[i][:-1]:
            x = np.array([[tok]], np.int32)
            want, jc = jstep(params, x, jc)
            got, tc = tdense.decode_step(tparams, pcfg, torch.as_tensor(x), tc)
            assert_bf16_close(got, want, f"req {i} decode")


def test_registry_and_launcher_rehearsal(capsys):
    from repro_torch.launch import serve
    assert tconfigs.ARCH_IDS == list(tconfigs._MODULES)
    glm = tconfigs.get_config("glm4-9b")
    assert (glm.n_layer, glm.d_model, glm.n_head, glm.n_kv_head, glm.d_head,
            glm.d_ff, glm.vocab, glm.qkv_bias) == (40, 4096, 32, 2, 128,
                                                    13696, 151552, True)
    modules = {"audio": "whisper", "vlm": "vlm"}
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch)
        assert get_model(cfg).__name__ == (
            f"repro_torch.models.{modules.get(cfg.family, cfg.family)}")
    done = serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--prompt-len", "8", "--max-len", "32"])
    assert sorted(done) == [0, 1, 2] and all(len(v) == 4 for v in done.values())
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_engine_run_takes_the_references_greedy_keyword():
    """``run(requests, greedy=True)`` is accepted, as the reference's
    ``DecodeEngine.run(requests, *, greedy=True)`` is, and gives the tokens
    of ``run(requests)``: sampling is greedy either way.  glm4-9b at the
    launcher's ``--smoke`` size."""
    pcfg = tconfigs.get_smoke_config("glm4-9b")
    model = tdense.init_params(pcfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, pcfg.vocab, 8, dtype=np.int32) for _ in range(3)]

    def serve(**kw):
        engine = DecodeEngine(get_model(pcfg), pcfg, model, batch_slots=2,
                              max_len=32, device="cpu")
        return engine.run([Request(rid=i, prompt=p, max_new_tokens=4)
                           for i, p in enumerate(prompts)], **kw)

    plain = serve()
    assert sorted(plain) == [0, 1, 2]
    assert all(len(v) == 4 for v in plain.values())
    assert serve(greedy=True) == plain
