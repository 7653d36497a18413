"""NMS feature extraction and descriptors of the port against `sfm_tpu`:
bit-equal tables, same emission order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.models import matcher as jmatcher
from sfm_tpu.ops import descriptors as jdesc
from sfm_tpu.ops import filters as jfilters
from sfm_tpu.ops import nms as jnms
from sfm_tpu_torch.models import matcher as tmatcher
from sfm_tpu_torch.ops import descriptors as tdesc
from sfm_tpu_torch.ops import filters as tfilters
from sfm_tpu_torch.ops import nms as tnms
from sfm_tpu_torch.utils.synthetic import SceneConfig, make_sequence

W, H = 320, 160


@pytest.fixture(scope="module")
def image():
    left, _ = make_sequence(1, SceneConfig(width=W, height=H, f=166.0,
                                           cu=160.0, cv=80.0))
    return left[0]


def _assert_feature_sets_equal(got, want):
    for name in tnms.FeatureSet._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert str(g.dtype).split(".")[1] == str(w.dtype), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("n,tau,cap", [(3, 50, 2048), (9, 50, 256),
                                       (3, 20, 100), (2, 50, 777)])
def test_nms_features_bit_equal(image, n, tau, cap):
    jf1, jf2 = (jfilters.blob5x5(jnp.asarray(image)),
                jfilters.checkerboard5x5(jnp.asarray(image)))
    tf1, tf2 = (tfilters.blob5x5(torch.from_numpy(image)),
                tfilters.checkerboard5x5(torch.from_numpy(image)))
    want = jnms.nms_features(jf1, jf2, w=W, h=H, n=n, tau=tau, cap=cap)
    got = tnms.nms_features(tf1, tf2, w=W, h=H, n=n, tau=tau, cap=cap)
    assert int(got.count) > 20
    _assert_feature_sets_equal(got, want)


def test_nms_on_random_responses_with_ties():
    """Small-range random responses force equal extrema inside blocks and
    windows: the tie order must be the reference's."""
    rs = np.random.RandomState(5)
    f1 = (rs.randint(-3, 4, (64, 96)) * 40).astype(np.int16)
    f2 = (rs.randint(-3, 4, (64, 96)) * 40).astype(np.int16)
    want = jnms.nms_features(jnp.asarray(f1), jnp.asarray(f2), w=96, h=64,
                             n=2, tau=50, cap=512)
    got = tnms.nms_features(torch.from_numpy(f1), torch.from_numpy(f2), w=96,
                            h=64, n=2, tau=50, cap=512)
    assert int(got.count) > 10
    _assert_feature_sets_equal(got, want)


def test_nms_emission_ascending_u(image):
    """Features come out x-block major, so `u` ascends at block granularity."""
    n = 3
    img = torch.from_numpy(image)
    fs = tnms.nms_features(tfilters.blob5x5(img), tfilters.checkerboard5x5(img),
                           w=W, h=H, n=n, tau=50, cap=2048)
    cnt = int(fs.count)
    assert cnt > 50
    ublk = (fs.u.numpy()[:cnt] - (n + tnms.MARGIN)) // (n + 1)
    assert np.all(np.diff(ublk) >= 0)


def test_nms_too_small_image_is_empty():
    z = torch.zeros((10, 10), dtype=torch.int16)
    fs = tnms.nms_features(z, z, w=10, h=10, n=3, tau=50, cap=16)
    assert int(fs.count) == 0 and fs.u.shape == (16,) and not bool(fs.valid.any())


@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_sparse_nms_n(n):
    assert tnms.sparse_nms_n(n) == jnms.sparse_nms_n(n)


@pytest.mark.parametrize("fn", ["compute_descriptors",
                                "compute_small_descriptors"])
def test_descriptors_bit_equal(image, fn):
    rs = np.random.RandomState(3)
    du, dv = jfilters.sobel5x5(jnp.asarray(image))
    # border and out-of-image positions included: flat indices clip alike
    u = rs.randint(-3, W + 3, 300).astype(np.int32)
    v = rs.randint(-3, H + 3, 300).astype(np.int32)
    want = getattr(jdesc, fn)(du, dv, jnp.asarray(u), jnp.asarray(v))
    got = getattr(tdesc, fn)(torch.from_numpy(np.asarray(du)),
                             torch.from_numpy(np.asarray(dv)),
                             torch.from_numpy(u), torch.from_numpy(v))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("half,multi", [(1, 1), (0, 1), (1, 0)])
def test_detect_features_bit_equal(image, half, multi):
    kw = dict(w=W, h=H, nms_n=3, nms_tau=50, multi_stage=multi,
              half_resolution=half, cap_sparse=256, cap_dense=512)
    want = jmatcher.detect_features(jnp.asarray(image), **kw)
    got = tmatcher.detect_features(torch.from_numpy(image), **kw)
    _assert_feature_sets_equal(got.sparse, want.sparse)
    _assert_feature_sets_equal(got.dense, want.dense)
    for name in ("du_full", "dv_full", "img"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
