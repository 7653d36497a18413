"""The ported slice as a whole: the fused stereo VO frame step of
`sfm_tpu_torch` on `device="cpu"` against `sfm_tpu`'s on the JAX CPU backend,
frame by frame on the same images, the same prior and the same uniform draws
(taken from `jax.random.uniform` on the keys the JAX step splits off).

Tolerances: feature tables, gradients and the match table are bit-equal
(integer stages, exact SAD, first-index ties). `tr` is held to 1e-3 absolute:
both sides run float32 Gauss-Newton to a 1e-6 step, but sum the normal
equations in different orders, so the converged vectors differ in the last
digits (observed differences are below 1e-5).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jcfg
from sfm_tpu.models import matcher as jmatcher
from sfm_tpu.models import pipeline as jpipeline
from sfm_tpu.ops import se3 as jse3
from sfm_tpu_torch import config as tcfg
from sfm_tpu_torch import convert
from sfm_tpu_torch.models.pipeline import (StereoFrameStep,
                                           make_stereo_frame_step)
from sfm_tpu_torch.ops.se3 import transformation_vector_to_matrix
from sfm_tpu_torch.utils.synthetic import SceneConfig, make_sequence

HERE = os.path.dirname(__file__)
TR_TOL = 1e-3

ENGINE_KW = dict(max_features_dense=512, max_features_sparse=256,
                 max_matches=512, refine_window=256)


def _configs(f, cu, cv, base, ransac_iters=50):
    jp = jcfg.StereoParams(calib=jcfg.Calibration(f=f, cu=cu, cv=cv),
                           base=base, ransac_iters=ransac_iters,
                           bucket=jcfg.Bucketing(max_features=3))
    je = jcfg.EngineConfig(**ENGINE_KW)
    tp = convert.config_from_dict(dataclasses.asdict(jp))
    te = convert.config_from_dict(dataclasses.asdict(je))
    assert isinstance(tp, tcfg.StereoParams) and isinstance(te, tcfg.EngineConfig)
    return jp, je, tp, te


def _jax_detect(img, w, h, p, e):
    return jmatcher.detect_features(
        jnp.asarray(img), w=w, h=h, nms_n=p.nms_n, nms_tau=p.nms_tau,
        multi_stage=p.multi_stage, half_resolution=p.half_resolution,
        cap_sparse=e.max_features_sparse, cap_dense=e.max_features_dense)


def _assert_tree_equal(got, want, what):
    """Every field of a container of the port equals the JAX container's."""
    _assert_np_tree_equal(convert.to_numpy(got), want, what)


def _assert_np_tree_equal(got, want, what):
    for name in type(got)._fields:
        a, b = getattr(got, name), getattr(want, name)
        if hasattr(a, "_fields"):
            _assert_np_tree_equal(a, b, f"{what}.{name}")
        elif a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{what}.{name}")


def _run_both(left, right, w, h, f, cu, cv, base, n_frames):
    jp, je, tp, te = _configs(f, cu, cv, base)
    jstep = jpipeline.make_stereo_frame_step(w, h, jp, je)
    tstep = make_stereo_frame_step(w, h, tp, te, device="cpu")
    assert isinstance(tstep, StereoFrameStep)

    jprev_l = _jax_detect(left[0], w, h, jp.match, je)
    jprev_r = _jax_detect(right[0], w, h, jp.match, je)
    tprev_l, tprev_r = tstep.detect(left[0]), tstep.detect(right[0])
    _assert_tree_equal(tprev_l, jprev_l, "frame0.left")
    # the converter gives the same state from the JAX values
    conv = convert.frame_features_from_numpy(
        jax.tree.map(np.asarray, jprev_r), "cpu")
    _assert_tree_equal(conv, jprev_r, "frame0.right(converted)")

    jtrp = jnp.eye(4, dtype=jnp.float32)
    ttrp = torch.eye(4, dtype=torch.float32)
    key = jax.random.PRNGKey(0)
    n_matches = []
    for i in range(1, n_frames):
        key, sub = jax.random.split(key)
        k_bucket, k_ransac = jax.random.split(sub)
        r_bucket = np.asarray(jax.random.uniform(k_bucket, (je.max_matches,)))
        u_ransac = np.asarray(jax.random.uniform(k_ransac,
                                                 (jp.ransac_iters, 3)))
        jprev_l, jprev_r, jm, jres = jstep(
            jprev_l, jprev_r, jnp.asarray(left[i]), jnp.asarray(right[i]),
            jtrp, sub)
        tprev_l, tprev_r, tm, tres = tstep(
            tprev_l, tprev_r, left[i], right[i], ttrp,
            r_bucket=torch.from_numpy(r_bucket),
            u_ransac=torch.from_numpy(u_ransac))

        _assert_tree_equal(tprev_l, jprev_l, f"frame{i}.cur_l")
        _assert_tree_equal(tprev_r, jprev_r, f"frame{i}.cur_r")
        _assert_tree_equal(tm, jm, f"frame{i}.matches")
        assert int(tres.n_matches) == int(jres.n_matches)
        assert int(tres.n_inliers) == int(jres.n_inliers), i
        assert bool(tres.success) == bool(jres.success), i
        np.testing.assert_array_equal(tres.inliers.numpy(),
                                      np.asarray(jres.inliers))
        np.testing.assert_allclose(tres.tr.numpy(), np.asarray(jres.tr),
                                   rtol=0, atol=TR_TOL)
        n_matches.append(int(jres.n_matches))
        if bool(jres.success):
            jtrp = jse3.transformation_vector_to_matrix(jres.tr)
            ttrp = transformation_vector_to_matrix(tres.tr)
    return n_matches


def test_stereo_step_matches_jax_on_synthetic_frames():
    W, H = 480, 160
    scfg = SceneConfig(width=W, height=H, f=240.0, cu=240.0, cv=80.0,
                       wall_dist=5.0, far_dist=40.0)
    left, right, _ = make_sequence(4, scfg, step=0.4, baseline=0.5)
    n = _run_both(left, right, W, H, scfg.f, scfg.cu, scfg.cv, 0.5, 4)
    assert min(n) > 30, n   # the comparison is not over empty tables


def _read_pgm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w)


def test_stereo_step_matches_jax_on_real_texture_frames():
    data = os.path.join(HERE, "data", "real_seq")
    left = [_read_pgm(os.path.join(data, f"{i:06d}_l.pgm")) for i in range(3)]
    right = [_read_pgm(os.path.join(data, f"{i:06d}_r.pgm")) for i in range(3)]
    n = _run_both(left, right, 512, 160, 280.0, 256.0, 80.0, 0.571, 3)
    assert min(n) > 30, n


def test_no_device_argument_means_gpu_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_stereo_frame_step(320, 96, tcfg.StereoParams(),
                               tcfg.EngineConfig())


@pytest.mark.parametrize("params_kw,engine_kw", [
    ({}, {"outlier_mode": "grid"}),
    ({}, {"outlier_mode": "delaunay"}),
    ({"match": tcfg.MatcherParams(refinement=2)}, {}),
    ({}, {"refine_pre_filter": True}),
    ({}, {"batched_detect": True}),
    ({}, {"compute_gain": True}),
])
def test_unsupported_settings_raise(params_kw, engine_kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_stereo_frame_step(320, 96, tcfg.StereoParams(**params_kw),
                               tcfg.EngineConfig(**engine_kw), device="cpu")


def test_step_wants_explicit_randomness():
    step = make_stereo_frame_step(320, 96, tcfg.StereoParams(),
                                  tcfg.EngineConfig(**ENGINE_KW), device="cpu")
    img = np.zeros((96, 320), np.uint8)
    prev = step.detect(img)
    with pytest.raises(ValueError, match="randomness"):
        step(prev, prev, img, img, torch.eye(4))
