"""Motion estimation of the port against `sfm_tpu`: RANSAC sampling with
injected draws (equal), the small linear algebra, the Gauss-Newton solver and
the whole stereo estimate.

Tolerances: sampling and inlier masks are equal. Motion vectors are held to
1e-4 absolute: both sides iterate float32 Gauss-Newton to a 1e-6 step, and
sum the normal equations in another order, so they agree to about 1e-6 on
well-conditioned input (the observed maximum here is below 2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.models import stereo as jstereo
from sfm_tpu.ops import linalg as jlinalg
from sfm_tpu.ops import matching as jmatching
from sfm_tpu.ops import ransac as jransac
from sfm_tpu.ops import se3 as jse3
from sfm_tpu.ops import stereo_gn as jgn
from sfm_tpu_torch.models import stereo as tstereo
from sfm_tpu_torch.ops import linalg as tlinalg
from sfm_tpu_torch.ops import matching as tmatching
from sfm_tpu_torch.ops import ransac as transac
from sfm_tpu_torch.ops import se3 as tse3
from sfm_tpu_torch.ops import stereo_gn as tgn

TR_TOL = 1e-4
CALIB = np.array([240.0, 240.0, 80.0, 0.5], np.float32)
TR_TRUE = np.array([0.004, -0.02, 0.003, 0.03, -0.01, -0.4], np.float32)


@pytest.mark.parametrize("n,count,iters,k", [(256, 200, 50, 3), (64, 64, 20, 8),
                                             (32, 2, 10, 3), (16, 0, 5, 3)])
def test_draw_samples_with_injected_draws_equal(n, count, iters, k):
    key = jax.random.PRNGKey(7)
    valid = np.arange(n) < count
    u = np.array(jax.random.uniform(key, (iters, k)))   # what JAX draws
    want = np.asarray(jransac.draw_samples(key, jnp.asarray(valid), iters, k))
    got = transac.draw_samples(torch.from_numpy(valid), iters, k,
                               u=torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if count >= k:   # distinct indices of valid entries
        assert all(len(set(r)) == k and max(r) < count for r in got.tolist())


def test_draw_samples_generator_and_argument_checks():
    valid = torch.arange(100) < 80
    a = transac.draw_samples(valid, 30, 3, generator=torch.Generator().manual_seed(5))
    b = transac.draw_samples(valid, 30, 3, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and int(a.max()) < 80
    with pytest.raises(ValueError):
        transac.draw_samples(valid, 30, 3)
    with pytest.raises(ValueError):
        transac.draw_samples(valid, 30, 3, u=torch.zeros(30, 2))


def test_se3_helpers(rng):
    tr = rng.uniform(-0.3, 0.3, 6).astype(np.float32)
    T = tse3.transformation_vector_to_matrix(torch.from_numpy(tr))
    np.testing.assert_allclose(
        T.numpy(), np.asarray(jse3.transformation_vector_to_matrix(
            jnp.asarray(tr))), rtol=0, atol=1e-7)
    for g, w in zip(tse3.rotation_angles(T[:3, :3]),
                    jse3.rotation_angles(jnp.asarray(T.numpy()[:3, :3]))):
        np.testing.assert_allclose(float(g), float(w), atol=1e-6)
    np.testing.assert_allclose(tse3.se3_inverse(T).numpy(),
                               np.asarray(jse3.se3_inverse(jnp.asarray(T.numpy()))),
                               atol=1e-6)
    np.testing.assert_allclose((tse3.se3_inverse(T) @ T).numpy(), np.eye(4),
                               atol=1e-6)


def test_small_linalg(rng):
    B = rng.randn(5, 6, 6).astype(np.float32)
    A = B @ B.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    A[4] = -A[4]   # not positive definite: flagged, never NaN in `ok`
    b = rng.randn(5, 6).astype(np.float32)
    x, ok = tlinalg.solve_spd_small(torch.from_numpy(A), torch.from_numpy(b))
    jx, jok = jlinalg.solve_spd_small(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True] * 4 + [False]
    np.testing.assert_allclose(x.numpy()[:4], np.asarray(jx)[:4], rtol=1e-4,
                               atol=1e-5)
    M = rng.randn(7, 3, 3).astype(np.float32)
    np.testing.assert_allclose(tlinalg.inv3(torch.from_numpy(M)).numpy(),
                               np.asarray(jlinalg.inv3(jnp.asarray(M))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tlinalg.det3(torch.from_numpy(M)).numpy(),
                               np.asarray(jlinalg.det3(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-6)


def _scene(rs, cap, n_valid, outlier_share=0.2, noise=0.3):
    """A compacted quad match table from 3-D points moved by TR_TRUE."""
    f, cu, cv, base = CALIB
    X = rs.uniform(-6, 6, cap)
    Y = rs.uniform(-1.5, 1.6, cap)
    Z = rs.uniform(4, 30, cap)
    T = np.asarray(jse3.transformation_vector_to_matrix(jnp.asarray(TR_TRUE)),
                   np.float64)
    Pc = np.stack([X, Y, Z], 1) @ T[:3, :3].T + T[:3, 3]
    proj = lambda P, dx: (f * (P[:, 0] - dx) / P[:, 2] + cu,
                          f * P[:, 1] / P[:, 2] + cv)
    P0 = np.stack([X, Y, Z], 1)
    u1p, v1p = proj(P0, 0.0)
    u2p, v2p = proj(P0, base)
    u1c, v1c = proj(Pc, 0.0)
    u2c, v2c = proj(Pc, base)
    bad = rs.rand(cap) < outlier_share
    u1c = u1c + np.where(bad, rs.uniform(-40, 40, cap), rs.randn(cap) * noise)
    v1c = v1c + np.where(bad, rs.uniform(-40, 40, cap), rs.randn(cap) * noise)
    valid = np.arange(cap) < n_valid
    fl = lambda a: np.where(valid, a, -1).astype(np.float32)
    i = np.where(valid, np.arange(cap), -1).astype(np.int32)
    return dict(u1p=fl(u1p), v1p=fl(v1p), i1p=i, u2p=fl(u2p), v2p=fl(v2p), i2p=i,
                u1c=fl(u1c), v1c=fl(v1c), i1c=i, u2c=fl(u2c), v2c=fl(v2c), i2c=i,
                valid=valid, count=np.int32(n_valid))


def _pts_obs(d):
    f, cu, cv, base = CALIB
    disp = np.maximum(d["u1p"] - d["u2p"], 1e-4)
    pts = np.stack([(d["u1p"] - cu) * base / disp, (d["v1p"] - cv) * base / disp,
                    f * base / disp], -1).astype(np.float32)
    obs = np.stack([d["u1c"], d["v1c"], d["u2c"], d["v2c"]], -1)
    return pts, obs


@pytest.mark.parametrize("reweighting", [True, False])
def test_residuals_and_jacobian_close(rng, reweighting):
    pts, obs = _pts_obs(_scene(rng, 40, 40))
    tr = (TR_TRUE * 0.5).astype(np.float32)
    w = (rng.rand(40) > 0.3).astype(np.float32)
    want = jgn.residuals_and_jacobian(jnp.asarray(tr), jnp.asarray(pts),
                                      jnp.asarray(obs), jnp.asarray(w),
                                      jnp.asarray(CALIB), reweighting)
    got = tgn.residuals_and_jacobian(*(torch.from_numpy(a) for a in
                                       (tr, pts, obs, w, CALIB)), reweighting)
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-3)


def test_gn_solve_batched_close(rng):
    """A batch of 3-point hypotheses, as RANSAC runs them."""
    pts, obs = _pts_obs(_scene(rng, 90, 90, outlier_share=0.0, noise=0.0))
    pts_s, obs_s = pts.reshape(30, 3, 3), obs.reshape(30, 3, 4)
    ones = np.ones((30, 3), np.float32)
    tr0 = np.zeros((30, 6), np.float32)
    jtr, jst = jgn.gn_solve(jnp.asarray(tr0), jnp.asarray(pts_s),
                            jnp.asarray(obs_s), jnp.asarray(ones),
                            jnp.asarray(CALIB), 21, 1e-6, True)
    ttr, tst = tgn.gn_solve(*(torch.from_numpy(a) for a in
                              (tr0, pts_s, obs_s, ones, CALIB)), 21, 1e-6, True)
    assert tst.dtype == torch.int32
    both = (tst.numpy() == tgn.CONVERGED) & (np.asarray(jst) == jgn.CONVERGED)
    assert both.sum() >= 20   # 3-point problems: a few are ill-conditioned
    np.testing.assert_allclose(ttr.numpy()[both], np.asarray(jtr)[both],
                               rtol=0, atol=2e-3)
    good = both & (np.abs(np.asarray(jtr) - TR_TRUE).max(1) < 1e-2)
    assert good.sum() >= 10
    np.testing.assert_allclose(ttr.numpy()[good], np.asarray(jtr)[good],
                               rtol=0, atol=TR_TOL)


@pytest.mark.parametrize("cap,n_valid,iters", [(256, 200, 50), (128, 128, 30)])
def test_stereo_estimate_motion_close(rng, cap, n_valid, iters):
    d = _scene(rng, cap, n_valid)
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (iters, 3)))
    want = jstereo.stereo_estimate_motion(
        jmatching.Matches(**{k: jnp.asarray(v) for k, v in d.items()}), key,
        jnp.asarray(CALIB), jnp.float32(2.0), ransac_iters=iters)
    got = tstereo.stereo_estimate_motion(
        tmatching.Matches(**{k: torch.from_numpy(np.asarray(v))
                             for k, v in d.items()}),
        torch.from_numpy(CALIB), 2.0, ransac_iters=iters,
        u=torch.from_numpy(u))
    assert bool(got.success) and bool(want.success)
    assert int(got.n_matches) == int(want.n_matches) == n_valid
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.tr.numpy(), np.asarray(want.tr), rtol=0,
                               atol=TR_TOL)
    np.testing.assert_allclose(got.tr.numpy(), TR_TRUE, atol=2e-2)  # noisy data
    assert 0.6 * n_valid < int(got.n_inliers) < 0.95 * n_valid


def test_stereo_estimate_motion_fails_cleanly_on_too_few_matches(rng):
    d = _scene(rng, 64, 4)
    got = tstereo.stereo_estimate_motion(
        tmatching.Matches(**{k: torch.from_numpy(np.asarray(v))
                             for k, v in d.items()}),
        torch.from_numpy(CALIB), 2.0, ransac_iters=10,
        generator=torch.Generator().manual_seed(0))
    assert not bool(got.success)
    assert torch.equal(got.tr, torch.zeros(6))   # identity motion, never NaN
