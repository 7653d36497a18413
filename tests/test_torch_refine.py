"""Patch extraction and pixel refinement of the port against `sfm_tpu`: the
plain patch extraction against the Pallas kernel (interpret mode) on rows
below `count`, zeros beyond; the relocation bit-equal with the JAX CPU path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import refine as jrefine
from sfm_tpu.ops.pallas_kernels import extract_patches_pallas
from sfm_tpu_torch.ops import cuda_kernels
from sfm_tpu_torch.ops import refine as trefine
from sfm_tpu_torch.ops.cuda_kernels import (PATCH, extract_patches,
                                            extract_patches_plain)

H, W = 64, 256


def _grads(rs, h=H, w=W):
    return (rs.randint(0, 256, (h, w)).astype(np.uint8),
            rs.randint(0, 256, (h, w)).astype(np.uint8))


@pytest.mark.parametrize("M,count", [(64, None), (64, 30), (77, 50), (77, 0)])
def test_extract_patches_plain_equals_pallas_interpret(rng, M, count):
    du, dv = _grads(rng)
    # corners over the whole image and past its borders: clipping and the
    # zero fill past (H, W) are part of the contract
    u0 = rng.randint(-5, W + 5, M).astype(np.int32)
    v0 = rng.randint(-5, H + 5, M).astype(np.int32)
    want = extract_patches_pallas(
        jnp.asarray(du, jnp.float32), jnp.asarray(dv, jnp.float32),
        jnp.asarray(u0), jnp.asarray(v0),
        None if count is None else jnp.int32(count), block=16)
    got = extract_patches_plain(
        torch.from_numpy(du), torch.from_numpy(dv), torch.from_numpy(u0),
        torch.from_numpy(v0), None if count is None else torch.tensor(count))
    n = M if count is None else count
    for g, w in zip(got, want):
        assert g.shape == (M, PATCH, PATCH) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])
        assert np.all(g.numpy()[n:] == 0.0)   # exactly the rows >= count


def test_extract_patches_window_contents(rng):
    du, dv = _grads(rng)
    u0 = np.array([0, 10, W - 16, W - 3, -4], np.int32)
    v0 = np.array([0, 7, H - 16, H - 2, 70], np.int32)
    pu, pv = extract_patches_plain(*(torch.from_numpy(a)
                                     for a in (du, dv, u0, v0)))
    for j in range(3):   # fully inside: the window itself
        np.testing.assert_array_equal(
            pu[j].numpy(), du[v0[j]:v0[j] + 16, u0[j]:u0[j] + 16])
        np.testing.assert_array_equal(
            pv[j].numpy(), dv[v0[j]:v0[j] + 16, u0[j]:u0[j] + 16])
    # past the right/bottom border: zeros beyond (H, W)
    np.testing.assert_array_equal(pu[3, :2, :3].numpy(), du[H - 2:, W - 3:])
    assert float(pu[3, 2:].abs().sum()) == 0 and float(pu[3, :, 3:].abs().sum()) == 0
    # corner clipped into the image: (-4, 70) -> (0, H-1)
    np.testing.assert_array_equal(pu[4, 0].numpy(), du[H - 1, :16])


def test_wrapper_on_cpu_takes_the_plain_version(rng):
    du, dv = _grads(rng)
    args = [torch.from_numpy(a) for a in (
        du, dv, rng.randint(0, W, 9).astype(np.int32),
        rng.randint(0, H, 9).astype(np.int32))]
    before = cuda_kernels.launch_counts()
    got = extract_patches(*args, 5)
    want = extract_patches_plain(*args, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_kernels.launch_counts() == before


def _refine_inputs(rs, M, n_valid):
    h, w = 96, 320
    du1, dv1 = _grads(rs, h, w)
    du2, dv2 = _grads(rs, h, w)
    # smooth the second pair towards the first so that minima are not random
    du2 = ((du1.astype(np.int32) * 3 + du2) // 4).astype(np.uint8)
    dv2 = ((dv1.astype(np.int32) * 3 + dv2) // 4).astype(np.uint8)
    live = np.arange(M) < n_valid
    f = lambda lo, hi: np.where(live, rs.randint(lo, hi, M), -1).astype(np.float32)
    u1, v1 = f(12, w - 12), f(12, h - 12)
    # targets include positions inside the margin (left unchanged)
    u2 = np.where(live, u1 + rs.randint(-2, 3, M), -1).astype(np.float32)
    v2 = np.where(live, v1 + rs.randint(-2, 3, M), -1).astype(np.float32)
    u2[:4] = [3, 7, w - 8, w - 9]
    return (du1, dv1, du2, dv2, u1, v1, u2, v2), (w, h)


def test_small_ref_descriptors_bit_equal(rng):
    (du1, dv1, _, _, u1, v1, _, _), _ = _refine_inputs(rng, 64, 64)
    want = jrefine.small_ref_descriptors(jnp.asarray(du1), jnp.asarray(dv1),
                                         jnp.asarray(u1), jnp.asarray(v1))
    got = trefine.small_ref_descriptors(*(torch.from_numpy(a)
                                          for a in (du1, dv1, u1, v1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,n_valid,window", [(128, 128, None), (128, 90, 64),
                                              (100, 60, 100), (100, 60, 300)])
def test_relocate_minimum_prefix_bit_equal(rng, M, n_valid, window):
    arrs, (w, h) = _refine_inputs(rng, M, n_valid)
    jw = jrefine.relocate_minimum_prefix(
        *(jnp.asarray(a) for a in arrs), jnp.float32(w), jnp.float32(h),
        window=window, count=jnp.int32(n_valid))
    tg = trefine.relocate_minimum_prefix(
        *(torch.from_numpy(a) for a in arrs), float(w), float(h),
        window=window, count=torch.tensor(n_valid))
    moved = 0
    for g, wnt, old in zip(tg, jw, arrs[6:8]):
        assert g.shape == (M,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        moved += int((g.numpy() != old).sum())
    assert moved > 10


def test_relocate_minimum_with_shared_reference(rng):
    """The pipeline extracts the reference descriptor once and passes it on."""
    arrs, (w, h) = _refine_inputs(rng, 64, 64)
    t = [torch.from_numpy(a) for a in arrs]
    ref = trefine.small_ref_descriptors(t[0], t[1], t[4], t[5], count=64)
    a = trefine.relocate_minimum(*t, float(w), float(h), ref=ref, count=64)
    b = trefine.relocate_minimum(*t, float(w), float(h))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
