"""Filters of the port against `sfm_tpu.ops.filters` and against the fused
Pallas kernel in interpret mode: bit-equal on the WHOLE image, wrapped
borders included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import filters as jfilters
from sfm_tpu.ops.pallas_kernels import detect_filters_pallas
from sfm_tpu_torch.ops import filters as tfilters
from sfm_tpu_torch.ops.cuda_kernels import (detect_filters,
                                            detect_filters_plain,
                                            launch_counts)

SHAPES = [(96, 320), (101, 203), (7, 9)]


def _img(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["sobel5x5", "blob5x5", "checkerboard5x5"])
def test_filter_bit_equal(name, shape):
    img = _img(shape)
    want = getattr(jfilters, name)(jnp.asarray(img))
    got = getattr(tfilters, name)(torch.from_numpy(img))
    if name == "sobel5x5":
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sobel_extreme_edges():
    """Hard edges drive the packed Sobel response to both ends of the range a
    u8 image can reach (128 -+ 96)."""
    img = np.zeros((32, 32), np.uint8)
    img[:, 16:] = 255
    img[16:, :] = 255 - img[16:, :]
    du, dv = tfilters.sobel5x5(torch.from_numpy(img))
    wdu, wdv = jfilters.sobel5x5(jnp.asarray(img))
    assert int(du.min()) == 32 and int(du.max()) == 223
    np.testing.assert_array_equal(du.numpy(), np.asarray(wdu))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(wdv))


@pytest.mark.parametrize("shape,out", [((96, 320), (48, 160)),
                                       ((97, 321), (48, 160))])
def test_half_resolution_bit_equal(shape, out):
    img = _img(shape, 1)
    want = jfilters.half_resolution(jnp.asarray(img), *out)
    got = tfilters.half_resolution(torch.from_numpy(img), *out)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("full", [True, False])
def test_detect_filters_plain_equals_pallas_interpret(shape, full):
    img = _img(shape, 2)
    want = detect_filters_pallas(jnp.asarray(img), with_blob_checker=full)
    got = detect_filters_plain(torch.from_numpy(img), with_blob_checker=full)
    assert len(got) == len(want) == (4 if full else 2)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_no_launch():
    img = torch.from_numpy(_img((40, 64), 3))
    before = launch_counts()
    got = detect_filters(img, with_blob_checker=True)
    want = detect_filters_plain(img, with_blob_checker=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launch_counts() == before
