"""kNN consistency voting of the port against `sfm_tpu`: masks equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.models import pipeline as jpipeline
from sfm_tpu.ops import matching as jmatching
from sfm_tpu.ops import outliers as joutliers
from sfm_tpu_torch.config import EngineConfig
from sfm_tpu_torch.models import pipeline as tpipeline
from sfm_tpu_torch.ops import matching as tmatching
from sfm_tpu_torch.ops import outliers as toutliers


def _inputs(rs, n, n_valid):
    u = rs.randint(0, 480, n).astype(np.float32)
    v = rs.randint(0, 160, n).astype(np.float32)
    valid = np.arange(n) < n_valid
    # a smooth flow field with a fifth of the rows knocked off it
    flow_u = np.round(u / 40.0) + np.where(rs.rand(n) < 0.2, rs.randint(-30, 30, n), 0)
    flow_v = np.round(v / 40.0) + np.where(rs.rand(n) < 0.2, rs.randint(-30, 30, n), 0)
    disp = np.round(20 - v / 10.0) + np.where(rs.rand(n) < 0.2, rs.randint(-20, 20, n), 0)
    return (u, v, valid, flow_u.astype(np.float32), flow_v.astype(np.float32),
            disp.astype(np.float32))


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,n_valid", [(256, 256), (200, 130), (64, 5)])
def test_knn_consistency_mask_equal(rng, method, weighted, n, n_valid):
    arrs = _inputs(rng, n, n_valid)
    kw = dict(k=8, min_support=4, weighted=weighted)
    want = joutliers.knn_consistency_mask(*(jnp.asarray(a) for a in arrs),
                                          method, 5.0, 5.0, **kw)
    got = toutliers.knn_consistency_mask(*(torch.from_numpy(a) for a in arrs),
                                         method, 5.0, 5.0, **kw)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_valid > 100:   # the vote both keeps and rejects
        assert 0 < int(got.sum()) < n_valid


@pytest.mark.parametrize("method", [0, 1, 2])
def test_pairwise_agreement_equal(rng, method):
    _, _, _, fu, fv, dp = _inputs(rng, 50, 50)
    want = joutliers._pairwise_agreement(jnp.asarray(fu), jnp.asarray(fv),
                                         jnp.asarray(dp), method, 5.0, 4.0)
    got = toutliers._pairwise_agreement(torch.from_numpy(fu),
                                        torch.from_numpy(fv),
                                        torch.from_numpy(dp), method, 5.0, 4.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,limit", [("knnw", None), ("knn", None),
                                        ("knnw", 128)])
def test_pipeline_outliers_stage_bit_equal(rng, mode, limit):
    n = 256
    u, v, valid, fu, fv, dp = _inputs(rng, n, 100)
    i = np.arange(n, dtype=np.int32)
    d = dict(u1p=u - fu, v1p=v - fv, i1p=i, u2p=u - fu - dp, v2p=v - fv, i2p=i,
             u1c=u, v1c=v, i1c=i, u2c=u - dp, v2c=v, i2c=i, valid=valid,
             count=np.int32(valid.sum()))
    jm = jmatching.Matches(**{k: jnp.asarray(x) for k, x in d.items()})
    tm = tmatching.Matches(**{k: torch.from_numpy(np.asarray(x))
                              for k, x in d.items()})
    want = jpipeline._outliers(jm, 2, 5, 5, n, mode, None, limit=limit)
    got = tpipeline._outliers(tm, 2, 5, 5, n, mode, EngineConfig(), limit=limit)
    assert 0 < int(got.count) < 100
    for name in tmatching.Matches._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_pipeline_outliers_other_modes_raise(rng):
    m = tmatching.empty_matches(8)
    for mode in ("grid", "delaunay"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipeline._outliers(m, 2, 5, 5, 8, mode)
