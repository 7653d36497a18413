"""Matching stage of the port against `sfm_tpu`: the plain SAD-argmin pass
against both the jnp pass and the Pallas kernel (interpret mode), with priors
on and off, forced ties, count gating and odd capacities; compaction, prior
statistics, bucketing with injected draws, and the quad closure.

Indices are equal and costs bit-equal on every row that has a match (one
stated exception: fractional prior targets, 2 ulp); tables are bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.models import matcher as jmatcher
from sfm_tpu.ops import matching as jmatching
from sfm_tpu.ops.pallas_kernels import sad_argmin_pallas
from sfm_tpu_torch.models import matcher as tmatcher
from sfm_tpu_torch.ops import cuda_kernels
from sfm_tpu_torch.ops import matching as tmatching
from sfm_tpu_torch.ops.nms import FeatureSet
from sfm_tpu_torch.utils.synthetic import SceneConfig, make_sequence


def _sad_inputs(rs, n1, n2, prior, ties=False, p_valid=0.8):
    d1 = rs.randint(0, 256, (n1, 32)).astype(np.float32)
    d2 = rs.randint(0, 256, (n2, 32)).astype(np.float32)
    if ties:  # duplicate candidates: equal costs, the first index must win
        d2[1::3] = d2[0]
        d1[::2] = d2[0]
    c1 = rs.randint(0, 4, n1).astype(np.int32)
    c2 = rs.randint(0, 4, n2).astype(np.int32)
    u1 = rs.randint(0, 300, n1).astype(np.float32)
    v1 = rs.randint(0, 150, n1).astype(np.float32)
    u2 = rs.randint(0, 300, n2).astype(np.float32)
    v2 = rs.randint(0, 150, n2).astype(np.float32)
    if ties:  # same position too, so the prior term ties as well
        u2[1::3], v2[1::3], c2[1::3] = u2[0], v2[0], c2[0]
    valid2 = rs.rand(n2) < p_valid
    if prior:
        frac = (0.37, 0.21) if prior == "fractional" else (0.0, 0.0)
        on = rs.rand(n1) > 0.5
        t_u = np.where(on, u1 + 3 + frac[0], -1.0).astype(np.float32)
        t_v = np.where(on, v1 + 2 - frac[1], -1.0).astype(np.float32)
    else:
        t_u = t_v = np.full(n1, -1.0, np.float32)
    return (d1, c1, u1 - 60, u1 + 60, v1 - 40, v1 + 40, t_u, t_v,
            d2, u2, v2, c2, valid2)


def _t(args):
    return tuple(torch.from_numpy(np.asarray(a)) for a in args)


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


@pytest.mark.parametrize("n1,n2", [(128, 256), (120, 200), (7, 33)])
@pytest.mark.parametrize("prior", [False, "integer", "fractional"])
@pytest.mark.parametrize("ties", [False, True])
def test_sad_argmin_pass_equals_jnp_and_pallas(rng, n1, n2, prior, ties):
    """Costs are bit-equal whenever the prior distance is built from exact
    squares (prior off, or integer offsets). With fractional prior targets
    XLA's CPU code contracts dx*dx + dy*dy into one fused multiply-add, while
    the port rounds every operation (which is what its CUDA kernel reproduces
    with round-to-nearest intrinsics): there the costs may differ in the last
    bit, so they are held to 2 ulp (2.4e-7 relative)."""
    args = _sad_inputs(rng, n1, n2, prior, ties)
    idx, cost = tmatching.sad_argmin_pass(*_t(args), chunk=50)
    assert idx.dtype == torch.int32 and cost.dtype == torch.float32
    jidx, jcost = jmatching.sad_argmin_pass(*_j(args), chunk=64)
    pidx, pcost = sad_argmin_pallas(*_j(args), tm=64, tn=64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    hit = np.asarray(jcost) < 1e7
    assert hit.sum() > 0 or n1 < 100
    if prior == "fractional":
        np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=2.4e-7)
        np.testing.assert_allclose(cost.numpy()[hit], np.asarray(pcost)[hit],
                                   rtol=2.4e-7)
    else:
        np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
        np.testing.assert_array_equal(cost.numpy()[hit], np.asarray(pcost)[hit])
    # no match: index 0 on both sides, MIN_COST_INIT in the kernel
    assert np.all(idx.numpy()[~hit] == 0)
    assert np.all(np.asarray(pcost)[~hit] == tmatching.MIN_COST_INIT)


def test_sad_argmin_ties_take_the_lowest_index():
    """Candidates 3, 5 and 9 are the same feature as every source row; the
    winner is the lowest valid one of them, with and without the prior."""
    rs = np.random.RandomState(1)
    n1, n2 = 6, 12
    d2 = rs.randint(0, 256, (n2, 32)).astype(np.float32)
    d2[5] = d2[9] = d2[3]
    d1 = np.repeat(d2[3:4], n1, 0)
    pos = np.full(n2, 50.0, np.float32)
    cls2 = np.zeros(n2, np.int32)
    lo, hi = np.zeros(n1, np.float32), np.full(n1, 100.0, np.float32)
    for prior in (-1.0, 48.5):
        t = np.full(n1, prior, np.float32)
        for dead, winner in ((), 3), ((3,), 5), ((3, 5), 9):
            valid2 = np.ones(n2, bool)
            valid2[list(dead)] = False
            idx, cost = tmatching.sad_argmin_pass(*_t(
                (d1, np.zeros(n1, np.int32), lo, hi, lo, hi, t, t, d2, pos, pos,
                 cls2, valid2)))
            assert idx.tolist() == [winner] * n1
            assert cost.unique().numel() == 1


def test_sad_argmin_count_gated(rng):
    """Mirror of the Pallas count-gating test: with compacted tables, rows
    below count1 agree with the kernel run with counts."""
    n1 = n2 = 128
    cnt1, cnt2 = 70, 90
    args = list(_sad_inputs(rng, n1, n2, False))
    args[12] = np.arange(n2) < cnt2
    idx, cost = tmatching.sad_argmin(*_t(args), count1=torch.tensor(cnt1),
                                     count2=torch.tensor(cnt2))
    pidx, pcost = sad_argmin_pallas(*_j(args), count1=jnp.int32(cnt1),
                                    count2=jnp.int32(cnt2), tm=32, tn=64)
    np.testing.assert_array_equal(idx.numpy()[:cnt1], np.asarray(pidx)[:cnt1])
    hit = cost.numpy()[:cnt1] < 1e7
    np.testing.assert_array_equal(cost.numpy()[:cnt1][hit],
                                  np.asarray(pcost)[:cnt1][hit])


def test_dispatcher_and_wrapper_use_the_plain_pass_on_cpu(rng):
    args = _t(_sad_inputs(rng, 40, 50, "fractional"))
    before = cuda_kernels.launch_counts()
    want = tmatching.sad_argmin_pass(*args)
    for fn in (tmatching.sad_argmin, cuda_kernels.sad_argmin):
        got = fn(*args, valid1=None, count1=None, count2=None)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_kernels.launch_counts() == before


def _matches(rs, cap, n_valid, packed=False):
    f = lambda lo, hi: rs.randint(lo, hi, cap).astype(np.float32)
    i = lambda: rs.randint(0, cap, cap).astype(np.int32)
    valid = (np.arange(cap) < n_valid) if packed else (rs.rand(cap) < n_valid / cap)
    u1p, v1p = f(10, 470), f(10, 150)
    return dict(u1p=u1p, v1p=v1p, i1p=i(), u2p=u1p - f(0, 30), v2p=v1p, i2p=i(),
                u1c=u1p + f(-9, 10), v1c=v1p + f(-4, 5), i1c=i(),
                u2c=u1p - f(0, 30), v2c=v1p + f(-4, 5), i2c=i(), valid=valid,
                count=np.int32(valid.sum()))


def _tm(d):
    return tmatching.Matches(**{k: torch.from_numpy(np.asarray(v))
                                for k, v in d.items()})


def _jm(d):
    return jmatching.Matches(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_matches_equal(got, want):
    for name in tmatching.Matches._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert str(g.dtype) == str(w.dtype), name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("cap_out", [64, 200, 256])
def test_compact_matches_bit_equal(rng, cap_out):
    d = _matches(rng, 200, 120)
    _assert_matches_equal(tmatching.compact_matches(_tm(d), cap_out),
                          jmatching.compact_matches(_jm(d), cap_out))


def test_empty_matches():
    _assert_matches_equal(tmatching.empty_matches(9), jmatching.empty_matches(9))


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("n_valid", [0, 5, 150])
def test_compute_prior_statistics_bit_equal(rng, method, n_valid):
    d = _matches(rng, 256, n_valid, packed=True)
    kw = dict(method=method, n_bins_u=10, n_bins_v=4, binsize=50,
              match_radius=100.0)
    got = tmatching.compute_prior_statistics(_tm(d), **kw)
    want = jmatching.compute_prior_statistics(_jm(d), **kw)
    for name in tmatching.RangeTable._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    sb = rng.randint(0, 40, 30)
    for g, w in zip(tmatching.lookup_ranges(got, torch.from_numpy(sb), 1),
                    jmatching.lookup_ranges(want, jnp.asarray(sb), 1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_features,cap", [(2, 128), (5, 256), (1000, 256)])
def test_bucket_matches_with_injected_draws_bit_equal(rng, max_features, cap):
    d = _matches(rng, 256, 180, packed=True)
    key = jax.random.PRNGKey(3)
    r = np.array(jax.random.uniform(key, (256,)))   # what the JAX side draws
    want = jmatching.bucket_matches(_jm(d), key, max_features, 50.0, 50.0, cap)
    got = tmatching.bucket_matches(_tm(d), max_features, 50.0, 50.0, cap,
                                   r=torch.from_numpy(r))
    _assert_matches_equal(got, want)
    assert 0 < int(got.count) <= 180


def test_bucket_matches_generator_and_argument_checks(rng):
    m = _tm(_matches(rng, 64, 40, packed=True))
    g = torch.Generator().manual_seed(0)
    a = tmatching.bucket_matches(m, 1, 50.0, 50.0, 64, generator=g)
    g = torch.Generator().manual_seed(0)
    b = tmatching.bucket_matches(m, 1, 50.0, 50.0, 64, generator=g)
    assert torch.equal(a.u1c, b.u1c) and 0 < int(a.count) < 40
    with pytest.raises(ValueError):
        tmatching.bucket_matches(m, 1, 50.0, 50.0, 64)
    with pytest.raises(ValueError):
        tmatching.bucket_matches(m, 1, 50.0, 50.0, 64, r=torch.zeros(3))


W, H = 320, 96


@pytest.fixture(scope="module")
def quad_features():
    scfg = SceneConfig(width=W, height=H, f=160.0, cu=160.0, cv=48.0,
                       wall_dist=5.0, far_dist=40.0)
    left, right, _ = make_sequence(2, scfg, step=0.4, baseline=0.5)
    kw = dict(w=W, h=H, nms_n=3, nms_tau=50, multi_stage=1, half_resolution=1,
              cap_sparse=256, cap_dense=512)
    jf = [jmatcher.detect_features(jnp.asarray(im), **kw)
          for im in (left[0], right[0], left[1], right[1])]
    tf = [tmatcher.detect_features(torch.from_numpy(im), **kw)
          for im in (left[0], right[0], left[1], right[1])]
    return jf, tf


@pytest.mark.parametrize("use_tr", [False, True])
@pytest.mark.parametrize("use_rt", [False, True])
def test_match_quad_bit_equal(quad_features, rng, use_tr, use_rt):
    jf, tf = quad_features
    kw = dict(w=W, h=H, binsize=50, nbu=7, nbv=2, radius=100.0, disp_tol=2.0,
              cap=512, use_rt=use_rt, use_tr=use_tr)
    tr = np.eye(4, dtype=np.float32)
    tr[2, 3] = -0.4
    calib = np.array([160.0, 160.0, 48.0, 0.5], np.float32)
    jrt = trt = None
    if use_rt:
        d = _matches(rng, 256, 150, packed=True)
        skw = dict(method=2, n_bins_u=7, n_bins_v=2, binsize=50,
                   match_radius=100.0)
        jrt = jmatching.compute_prior_statistics(_jm(d), **skw)
        trt = tmatching.compute_prior_statistics(_tm(d), **skw)
    want = jmatcher.match_quad(*(f.dense for f in jf), jrt, jnp.asarray(tr),
                               jnp.asarray(calib), **kw)
    got = tmatcher.match_quad(*(f.dense for f in tf), trt,
                              torch.from_numpy(tr), torch.from_numpy(calib),
                              **kw)
    assert int(got.count) > 20
    _assert_matches_equal(got, want)
