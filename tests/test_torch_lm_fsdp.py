"""The LM zoo's data-parallel, fully sharded training step
(``train.trainstep.make_lm_train_step`` over a (2, 1) mesh over ("data",
"model"), ``parallel.fsdp``) against the one-device step, on two gloo CPU
ranks; ``tests/test_torch_lm_train.py`` holds the one-device step to
``jax.value_and_grad`` of the JAX package's loss.

One module-scoped spawn of two ranks (``torch_lm_fsdp_worker.run``) serves
every test but the launcher's.  The families run at their reduced widths
with ``fsdp=True`` under an fp32 policy, one SGD step (lr 0.5, momentum
0.9, the gradient clipped at global norm 1, which every case exceeds), so
a parameter moves by a multiple of its gradient.  Cases: glm4-9b and
whisper-medium (``remat="layer"``: each layer gathered again in the
recompute), and one case for each risk of the sharded step: (a)
replicated leaves, (b) the clip's global norm over slices, (c) a mask
that gives the ranks unequal token counts, (d) microbatches, (e) a dim
the data extent does not divide (qwen2-moe with an expert hidden of 63:
its ``w_down`` banks stay whole; the MoE also routes over the global
batch).  Then checkpoints across layouts, ``bp_parallel_layer``, and the
launcher.

Tolerances: loss and gradient norm within 1e-5 relative; every gathered
updated parameter within 1e-4 of the largest move of the one-device step;
checkpoints and the slices they restore exactly; the BP layer exactly.
The launcher runs bf16: its first loss (the same weights) within 1e-6,
its second within 1e-3 relative (the ranks round their halves of a bf16
weight gradient before the sum; 2.5e-4 observed).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import dense as tdense
from repro_torch.models import get_model
from repro_torch.nn.layers import Policy
from repro_torch.parallel import ranks
from repro_torch.train import trainstep as ts
from repro_torch.train.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          train_state_tree)
from repro_torch.train.optim import sgd

import torch_lm_fsdp_worker as worker

TIMEOUT_S = 240
N, S = 4, 8
F32 = Policy(compute_dtype=torch.float32)


def _cases() -> dict:
    glm = worker.case_cfg({"arch": "glm4-9b"})
    mask = np.zeros((N, S), np.float32)
    mask[:2] = 1.0                  # rank 0: 16 tokens, rank 1: one
    mask[3, 5] = 1.0
    micro_mask = (np.random.default_rng(5).random((N, S)) < 0.6
                  ).astype(np.float32)
    whisper = worker.case_cfg({"arch": "whisper-medium"})
    moe = worker.case_cfg({"arch": "qwen2-moe-a2.7b"})
    return {
        "dense": {"arch": "glm4-9b", "overrides": {"remat": "layer"},
                  "batch": worker.batch_np(glm, N, S, 1)},
        "whisper": {"arch": "whisper-medium", "overrides": {"remat": "layer"},
                    "batch": worker.batch_np(whisper, N, S, 2)},
        "mask": {"arch": "glm4-9b",
                 "batch": worker.batch_np(glm, N, S, 3, mask)},
        "micro": {"arch": "glm4-9b", "microbatch": 2,
                  "batch": worker.batch_np(glm, N, S, 4, micro_mask)},
        "ragged": {"arch": "qwen2-moe-a2.7b",
                   "overrides": {"moe_d_ff": 63},
                   "batch": worker.batch_np(moe, N, S, 6)},
    }


def _save_one_device(case, directory):
    """One step of the one-device state of ``case``, saved as the
    launcher saves it; returns its parameters and first moments."""
    cfg = worker.case_cfg(case)
    lm = get_model(cfg)
    saved = tdense.BF16
    tdense.BF16 = F32
    try:
        model = lm.init_params(cfg, seed=2, device="cpu")
        opt = sgd(0.5, momentum=0.9)
        state = ts.init_lm_state(model, opt)
        state, _ = ts.make_lm_train_step(lm, cfg, opt)(
            state, worker._batch(case))
    finally:
        tdense.BF16 = saved
    mgr = CheckpointManager(directory, async_save=False)
    mgr.save(1, train_state_tree(ts.lm_full_state(state),
                                 stacked=bridge.LM_STACKED))
    return ({k: worker._np(p) for k, p in model.named_parameters()},
            {k: worker._np(t) for k, t in state["opt"].mu.items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    one_dir = str(tmp_path_factory.mktemp("ckpt_one"))
    two_dir = str(tmp_path_factory.mktemp("ckpt_two"))
    saved_one = _save_one_device(cases["dense"], one_dir)
    x = np.random.default_rng(8).standard_normal((2, 6, 128)).astype(
        np.float32)
    inp = {"cases": cases, "ckpt_one": one_dir, "ckpt_two": two_dir,
           "bp": {"arch": "glm4-9b", "x": x}}
    out = ranks.spawn(worker.run, 2, inp, device_type="cpu",
                      timeout_s=TIMEOUT_S, threads=1)
    return out, cases, saved_one, two_dir


def _moves(res):
    """(largest move of the one-device step, its params, the gathered)."""
    _, _, want = res["one"]
    move = max(np.abs(want[k] - res["p0"][k]).max() for k in want)
    return move, want, res["params"]


def _assert_step_equal(res):
    loss1, norm1, _ = res["one"]
    assert abs(res["loss"] - loss1) <= 1e-5 * abs(loss1)
    assert abs(res["grad_norm"] - norm1) <= 1e-5 * norm1
    move, want, got = _moves(res)
    assert move > 0
    assert set(got) == set(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * move, k


@pytest.mark.parametrize("name", ["dense", "whisper"])
def test_fsdp_step_equals_the_one_device_step(world, name):
    """The loss, the gradient norm and every gathered updated leaf; both
    ranks report the same loss; the layers were gathered in the forward
    and again in the remat recompute, and each gather's gradient
    reduce-scattered once."""
    r0, r1 = world[0][0][name], world[0][1][name]
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    _assert_step_equal(r0)
    sharded = [k for k, d in r0["dims"].items() if d is not None]
    in_layers = [k for k in sharded if ts.fsdp.in_stack(k)]
    assert r0["counts"]["reduce_scatter"] == len(sharded)
    assert r0["counts"]["all_gather"] == len(sharded) + len(in_layers)


@pytest.mark.parametrize("name", ["dense", "whisper"])
def test_each_rank_holds_the_slices_its_specs_name(world, name):
    """A sharded leaf and its moment are half their full dim on each rank
    (the dim the spec names 'data'); the others are whole; about half the
    parameters are held."""
    for rank in (0, 1):
        res = world[0][rank][name]
        for k, full in res["shapes"].items():
            d = res["dims"][k]
            want = list(full)
            if d is not None:
                assert full[d] % 2 == 0
                want[d] //= 2
            assert res["local"][k] == tuple(want) == res["mu_local"][k], k
        held = sum(np.prod(s) for s in res["local"].values())
        total = sum(np.prod(s) for s in res["shapes"].values())
        assert 0.5 * total < held < 0.6 * total


def test_replicated_leaves_take_the_whole_batch_gradient(world):
    """(a) Norm scales and biases (``r"ln"`` -> P()) are replicated; their
    gradients are summed over the data axis, so their update is the
    one-device step's on both ranks."""
    res = world[0][0]["whisper"]
    rep = [k for k, d in res["dims"].items() if d is None]
    assert any(k.endswith("ln1.scale") for k in rep)
    assert any(k.endswith(".b") for k in rep)
    move, want, got = _moves(res)
    for k in rep:
        own = np.abs(want[k] - res["p0"][k]).max()
        assert own > 0, k
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * move, k


def test_clip_norm_counts_each_element_once(world):
    """(b) The global norm over slices and replicated leaves equals the
    one-device norm, above the clip in every case, so the clipped step is
    the one-device step's."""
    for name in ("dense", "whisper", "mask", "micro", "ragged"):
        res = world[0][0][name]
        assert res["grad_norm"] > worker.CLIP
        assert abs(res["grad_norm"] - res["one"][1]) <= 1e-5 * res["one"][1]


def test_masked_loss_is_the_global_batch_mean(world):
    """(c) Rank 0's rows hold 16 valid tokens and rank 1's one: the loss
    and the step are the global batch's, not the mean of the two ranks'
    means."""
    cases = world[1]
    mask = cases["mask"]["batch"]["mask"]
    assert (mask[:2].sum(), mask[2:].sum()) == (16.0, 1.0)
    _assert_step_equal(world[0][0]["mask"])


def test_microbatches_split_each_ranks_rows(world):
    """(d) microbatch=2 over a masked global batch of 4: rank r runs its
    row of each microbatch, and the step equals the one-device step with
    the same microbatches."""
    _assert_step_equal(world[0][0]["micro"])


def test_a_dim_the_data_extent_does_not_divide_stays_whole(world):
    """(e) An expert hidden of 63: the ``w_down`` banks (E, 63, d) would
    split their 63 over 'data' and stay whole (nothing padded) while
    ``w_gate`` / ``w_up`` split d; the step (with the MoE's routing over
    the global batch) equals the one-device step."""
    res = world[0][1]["ragged"]
    downs = [k for k in res["dims"] if k.endswith("moe.w_down")]
    assert downs
    for k in downs:
        assert res["dims"][k] is None
        assert res["local"][k] == res["shapes"][k]
        gate = k.replace("w_down", "w_gate")
        assert res["dims"][gate] == 1
    _assert_step_equal(world[0][0]["ragged"])


def test_checkpoint_saved_on_two_ranks_restores_on_one(world):
    """Rank 0 writes the gathered arrays; a one-device state restores
    them exactly."""
    out, cases, _, two_dir = world
    cfg = worker.case_cfg(cases["dense"])
    lm = get_model(cfg)
    model = lm.init_params(cfg, seed=3, device="cpu")
    state = ts.init_lm_state(model, sgd(0.5, momentum=0.9))
    _, step = restore_checkpoint(two_dir, train_state_tree(
        state, stacked=bridge.LM_STACKED))
    assert step == 1
    got = out[0]["dense"]
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(worker._np(p), got["params"][k])
        np.testing.assert_array_equal(worker._np(state["opt"].mu[k]),
                                      got["mu"][k])


def test_checkpoint_saved_on_one_device_restores_on_two(world):
    """Each rank restores its slices of a one-device checkpoint exactly."""
    out, _, (params, mu), _ = world
    for rank in (0, 1):
        res, dims = out[rank]["restore"], out[rank]["dense"]["dims"]
        assert res["step"] == 1 and res["opt_step"] == 1
        for k, full in params.items():
            d = dims[k]
            want = full if d is None else np.split(full, 2, axis=d)[rank]
            want_mu = mu[k] if d is None else np.split(mu[k], 2, axis=d)[rank]
            np.testing.assert_array_equal(res["params"][k], want)
            np.testing.assert_array_equal(res["mu"][k], want_mu)


def test_bp_parallel_layer_equals_layer_apply(world):
    """Rank 0 computes the attention branch, rank 1 the MLP branch, one
    all-reduce merges them: the parallel block's output exactly, on both
    ranks; a serial block is refused."""
    for rank in (0, 1):
        res = world[0][rank]["bp"]
        assert res["diff"] == 0.0 and res["none"] and res["refused"]
        assert res["counts"]["psum"] == 1


def test_launcher_two_cpu_ranks_match_one_device():
    """``launch.train --arch glm4-9b --smoke --devices 2 --device cpu``
    against ``--devices 1``: the first loss (same weights, the forward
    split by rows) within 1e-6, the second within 1e-3 relative (bf16)."""
    from repro_torch.launch import train
    argv = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16"]
    with contextlib.redirect_stdout(io.StringIO()):
        one = train.main(argv)
    two = train.main(argv + ["--devices", "2"])
    assert sorted(one) == sorted(two) == [0, 1]
    assert abs(two[0] - one[0]) <= 1e-6 * abs(one[0])
    assert abs(two[1] - one[1]) <= 1e-3 * abs(one[1])


def test_launcher_without_a_card_raises_unless_asked_for_the_cpu():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the launcher would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "glm4-9b", "--smoke", "--steps", "1",
                    "--batch", "2", "--seq", "8", "--devices", "2"])
