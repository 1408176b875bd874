"""The port's bucket helpers (``repro_torch.serve.fold_steps``) equal the JAX
package's numpy helpers exactly."""
import dataclasses

import numpy as np
import pytest

from repro.core import config as jcfg
from repro.serve import fold_steps as jfs

from repro_torch.data.synthetic import fold_features
from repro_torch.serve import fold_steps as tfs

import torch_threads  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("preset", ["af2_tiny", "af2_small", "af2_initial",
                                    "af2_finetune"])
def test_default_buckets_equal(preset):
    cfg = getattr(jcfg, preset)()
    want = [dataclasses.astuple(b) for b in jfs.default_buckets(cfg)]
    assert [dataclasses.astuple(b) for b in tfs.default_buckets(cfg)] == want


def test_pad_stack_and_bucket_for_equal():
    cfg = jcfg.af2_tiny()
    feats = [fold_features(np.random.default_rng(i), dataclasses.replace(
        cfg, n_res=r, n_seq=s, n_extra_seq=se))
        for i, (r, s, se) in enumerate([(6, 4, 5), (12, 6, 10)])]
    jb = [jfs.Bucket(8, 4, 6), jfs.Bucket(16, 8, 12)]
    tb = [tfs.Bucket(8, 4, 6), tfs.Bucket(16, 8, 12)]
    for f in feats:
        assert (dataclasses.astuple(tfs.bucket_for(tb, f))
                == dataclasses.astuple(jfs.bucket_for(jb, f)))
    padded_t = [tfs.pad_to_bucket(f, tb[1]) for f in feats]
    padded_j = [jfs.pad_to_bucket(f, jb[1]) for f in feats]
    st, sj = tfs.stack_padded(padded_t, 3), jfs.stack_padded(padded_j, 3)
    assert sorted(st) == sorted(sj)
    for k in st:
        assert st[k].dtype == sj[k].dtype
        np.testing.assert_array_equal(st[k], sj[k])
    big = fold_features(np.random.default_rng(9), dataclasses.replace(
        cfg, n_res=32))
    with pytest.raises(ValueError, match="bucket table"):
        tfs.bucket_for(tb, big)
    with pytest.raises(ValueError, match="does not fit"):
        tfs.pad_to_bucket(feats[1], tb[0])
