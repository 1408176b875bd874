"""The port's serve launcher (``repro_torch.launch.serve``) on the CPU: fold
serving over two rank processes under the reference's ``--devices`` /
``--dap`` (``src/repro/launch/serve.py:167-180``), and LM decode serving of
the moe, ssm and hybrid families at their smoke sizes."""
import numpy as np
import pytest

from repro_torch.launch import serve

import torch_threads  # noqa: F401  (one intra-op thread)


def test_fold_over_two_cpu_ranks_equals_one_device(capfd):
    """``--devices 2 --dap 2``: two gloo CPU ranks, the longest bucket under
    ``ParallelPlan(data=1, dap=2)``; every request's fold equals the one
    device's: recycles exactly, pLDDT and contact probabilities within 2e-3
    relative L2 (a DAP shard may sum in another order; the card's long_plan
    phase holds the same bound), coordinates within 1e-3 (af2_tiny's
    zero-initialised structure updates leave them at the origin).  On this
    CPU the two runs agree bit for bit."""
    base = ["--fold", "tiny", "--device", "cpu", "--requests", "3"]
    one = serve.main(base)
    capfd.readouterr()
    two = serve.main(base + ["--devices", "2", "--dap", "2"])
    out = capfd.readouterr().out   # the ranks print: fd-level capture
    assert "backend gloo: 2 CPU ranks" in out
    assert "long plan  ParallelPlan[dp=1 bp=1 dap=2" in out
    assert "short plan ParallelPlan[dp=1 bp=1 dap=1" in out
    assert sorted(two) == sorted(one) == [0, 1, 2]
    for rid in one:
        a, b = two[rid], one[rid]
        assert a.n_recycles == b.n_recycles and a.bucket == b.bucket
        assert a.coords.shape == b.coords.shape
        np.testing.assert_allclose(a.coords, b.coords, rtol=0, atol=1e-3)
        for x, y in ((a.plddt, b.plddt), (a.contact_probs, b.contact_probs)):
            assert x.shape == y.shape and np.linalg.norm(y) > 0
            assert np.linalg.norm(x - y) <= 2e-3 * np.linalg.norm(y), rid


def test_dap_that_does_not_divide_the_devices_exits():
    with pytest.raises(SystemExit, match="--dap 3 does not divide the 2 "
                                         "available devices"):
        serve.main(["--fold", "tiny", "--device", "cpu", "--devices", "2",
                    "--dap", "3"])
    with pytest.raises(SystemExit, match="--featurize-workers must be 0"):
        serve.main(["--fold", "tiny", "--device", "cpu", "--devices", "2",
                    "--dap", "2", "--featurize-workers", "2"])


def test_long_plan_that_cannot_split_the_long_bucket_is_rejected():
    """af2_tiny's r-16 bucket does not split over dap 3: refused before any
    rank starts, with the reference's message."""
    with pytest.raises(SystemExit, match="fold plan rejected"):
        serve.main(["--fold", "tiny", "--device", "cpu", "--devices", "3",
                    "--dap", "3"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_lm_families_serve_at_smoke_size(arch, capsys):
    done = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--prompt-len", "8", "--max-len", "32"])
    assert sorted(done) == [0, 1, 2]
    assert all(len(v) == 4 and min(v) >= 0 and max(v) < 128
               for v in done.values())
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_audio_and_vlm_archs_are_refused():
    for arch in ("whisper-medium", "internvl2-26b"):
        with pytest.raises(SystemExit, match="token-prompt archs"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
