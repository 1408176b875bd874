"""The port's ``ParallelPlan``, ``auto_plan`` and roofline cost model against
the reference's, in one process (no rank processes but the launcher's),
and the training launcher over two CPU ranks.

Plans are held field for field against ``repro.parallel.plan.ParallelPlan``:
derived extents, ``describe``, serialisation, ``for_inference``,
``resolve_overlap``, ``apply_to`` and which plans ``validate`` refuses.
``auto_plan`` and ``estimate_block_time`` get the same hardware numbers on
both sides (the port's H100 ``HW``, passed explicitly to the reference's
``HW``), so they must choose and price alike."""
import dataclasses

import jax
import pytest

from repro.analysis import roofline as jroof
from repro.core import config as jconfig
from repro.parallel import plan as jplan

from repro_torch.analysis import roofline as troof
from repro_torch.core import config as tconfig
from repro_torch.parallel import plan as tplan

import torch_threads  # noqa: F401

PLANS = [
    {}, {"data": 4}, {"branch": 2}, {"dap": 2}, {"branch": 2, "dap": 2},
    {"pod": 2, "data": 2, "compress_pod_grads": True},
    {"dap": 4, "overlap_dap": True, "variant": "parallel"},
    {"dap": 2, "overlap_dap": False, "remat": "dots"},
    {"data": 2, "branch": 2, "attention_impl": "evo_pallas",
     "tri_mult_impl": "pallas", "opm_impl": "fused"},
    {"dap": 2, "variant": "af2"},
]

BAD = [
    {"branch": 3}, {"branch": 2, "variant": "af2"}, {"data": 0},
    {"compress_pod_grads": True}, {"overlap_dap": True},
    {"dap": 2, "branch": 2, "overlap_dap": True},
    {"dap": 2, "overlap_dap": True, "variant": "multimer"},
    {"remat": "everything"}, {"attention_impl": "fast"},
]


def _hw():
    hw = troof.HW()
    return hw, jroof.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                        ici_bw=hw.link_bw, coll_launch=hw.coll_launch,
                        tile_rows=hw.tile_rows, overlap_eff=hw.overlap_eff)


@pytest.mark.parametrize("kw", PLANS)
def test_plan_matches_reference(kw):
    ours, ref = tplan.ParallelPlan(**kw), jplan.ParallelPlan(**kw)
    cfg_t, cfg_j = tconfig.af2_tiny(), jconfig.af2_tiny()
    assert ours.to_dict() == ref.to_dict()
    assert (ours.n_devices, ours.group) == (ref.n_devices, ref.group)
    assert ours.describe() == ref.describe()
    assert ours.for_inference().to_dict() == ref.for_inference().to_dict()
    assert ours.resolve_overlap(cfg_t) == ref.resolve_overlap(cfg_j)
    assert ours.resolve_overlap() == ref.resolve_overlap()
    assert tplan.ParallelPlan.from_dict(ours.to_dict()) == ours
    assert (dataclasses.asdict(ours.apply_to(cfg_t))
            == dataclasses.asdict(ref.apply_to(cfg_j)))
    ours.validate(cfg_t)
    ref.validate(cfg_j)


@pytest.mark.parametrize("kw", BAD)
def test_plan_errors_match_reference(kw):
    with pytest.raises(jplan.PlanError):
        jplan.ParallelPlan(**kw).validate(jconfig.af2_tiny())
    with pytest.raises(tplan.PlanError):
        tplan.ParallelPlan(**kw).validate(tconfig.af2_tiny())


def test_plan_errors_on_shapes_and_flags():
    for mod, cfgs in ((tplan, tconfig), (jplan, jconfig)):
        with pytest.raises(mod.PlanError, match="does not divide cfg.n_seq"):
            mod.ParallelPlan(dap=3).validate(cfgs.af2_tiny())
        with pytest.raises(mod.PlanError, match="does not divide"):
            mod.ParallelPlan.from_flags(6, bp=2, dap=2)
        with pytest.raises(mod.PlanError, match="unknown ParallelPlan"):
            mod.ParallelPlan.from_dict({"dap": 2, "tp": 2})
    assert (tplan.ParallelPlan.from_flags(8, bp=2, dap=2).to_dict()
            == jplan.ParallelPlan.from_flags(8, bp=2, dap=2).to_dict())


def test_one_device_build_metadata_matches_reference():
    """A plan of one device builds without torch.distributed: no mesh, the
    serial block, and the reference's checkpoint metadata."""
    built = tplan.ParallelPlan().build(cfg=tconfig.af2_tiny())
    assert built.mesh is None and built.block_fn is None
    assert built.stack_io is None and built.dp_size == 1
    ref = jplan.ParallelPlan().build(jax.devices()[:1])
    assert built.metadata() == ref.metadata()
    with pytest.raises(tplan.PlanError, match="not initialised"):
        tplan.ParallelPlan(data=2).build()


@pytest.mark.parametrize("preset", ["initial", "finetune", "tiny"])
def test_roofline_block_time_matches_reference(preset):
    hw_t, hw_j = _hw()
    cfg_t = tconfig.PRESETS[preset]()
    cfg_j = {"initial": jconfig.af2_initial, "finetune": jconfig.af2_finetune,
             "tiny": jconfig.af2_tiny}[preset]()
    for bp, dap, ov in ((1, 1, None), (2, 1, None), (1, 4, None),
                        (2, 4, None), (1, 8, False)):
        a = troof.estimate_block_time(cfg_t, bp=bp, dap=dap, hw=hw_t,
                                      overlap=ov)
        b = jroof.estimate_block_time(cfg_j, bp=bp, dap=dap, hw=hw_j,
                                      overlap=ov)
        assert a == pytest.approx(b, rel=1e-12)
    assert troof.evo_branch_flops(cfg_t) == jroof.evo_branch_flops(cfg_j)
    assert (troof.dap_comm_bytes(cfg_t, 4, overlap=True)
            == jroof.dap_comm_bytes(cfg_j, 4, overlap=True))


@pytest.mark.parametrize("preset", ["initial", "finetune"])
@pytest.mark.parametrize("n,batch,pod", [(8, 4, 1), (8, 128, 1), (16, 2, 2),
                                         (4, 1, 1), (32, 4, 2)])
def test_auto_plan_matches_reference(preset, n, batch, pod):
    hw_t, hw_j = _hw()
    cfg_t = tconfig.PRESETS[preset]()
    cfg_j = {"initial": jconfig.af2_initial,
             "finetune": jconfig.af2_finetune}[preset]()
    ours = tplan.auto_plan(n, cfg_t, global_batch=batch, pod=pod, hw=hw_t)
    ref = jplan.auto_plan(n, cfg_j, global_batch=batch, pod=pod, hw=hw_j)
    assert ours.to_dict() == ref.to_dict()


def test_launcher_over_two_cpu_ranks(capfd):
    """``launch.train --devices 2 --dap 2`` spawns two gloo ranks and
    trains; the backend and every collective's route are printed, and
    both ranks report the same losses."""
    from repro_torch.launch import train
    out = train.main(["--af2", "tiny", "--steps", "1", "--batch", "1",
                      "--device", "cpu", "--devices", "2", "--dap", "2",
                      "--rank-timeout", "120", "--log-every", "1"])
    assert len(out) == 2 and out[0]["loss"] == out[1]["loss"]
    text = capfd.readouterr().out
    assert "backend gloo: 2 CPU ranks" in text
    assert "collective reduce_scatter: gloo all_reduce(SUM) + local slice" \
        in text


def test_graphs_refuse_gloo_collectives_on_a_card():
    """A CUDA graph cannot capture a gloo collective: under gloo on a card
    ``graphs=True`` raises and None means off; NCCL keeps the default."""
    import torch
    from repro_torch import graphs
    card = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo"):
        graphs.use_graphs(True, card, collectives="gloo")
    assert graphs.use_graphs(None, card, collectives="gloo") is False
    assert graphs.use_graphs(None, card, collectives="nccl") is True
    assert graphs.use_graphs(None, torch.device("cpu"), collectives="gloo") is False


def test_rank_processes_default_to_the_card(monkeypatch):
    """``spawn`` and ``from_env`` put their ranks on the card unless the
    caller names the CPU: without a card they raise before any process
    starts, as ``resolve_device`` does."""
    import torch
    from repro_torch.parallel import ranks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ranks.spawn(print, 2)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ranks.from_env()
    assert ranks.resolve_device_type("cpu") == "cpu"


@pytest.mark.parametrize("entry", ["train_step", "runner", "engine"])
def test_entry_points_take_a_parallel_plan(entry):
    """``make_af2_train_step``, ``TrainRunner`` and ``FoldEngine`` take a
    ``ParallelPlan`` or None and build it themselves (over ``ranks=``); a
    ``BuiltPlan`` is refused with the way to make a plan."""
    from repro_torch.core.model import AlphaFold2
    from repro_torch.serve.fold_engine import FoldEngine
    from repro_torch.train import optim
    from repro_torch.train.trainer import TrainRunner
    from repro_torch.train.trainstep import make_af2_train_step
    cfg = tconfig.af2_tiny()
    built = tplan.ParallelPlan().build(cfg=cfg)
    with pytest.raises(TypeError, match="ParallelPlan"):
        if entry == "train_step":
            make_af2_train_step(cfg, optim.sgd(0.1), built, device="cpu")
        elif entry == "runner":
            TrainRunner(cfg, built, device="cpu")
        else:
            FoldEngine(cfg, AlphaFold2(cfg, device="cpu"), plan=built,
                       device="cpu")
