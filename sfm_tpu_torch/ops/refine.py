"""Match coordinate refinement on full-resolution gradients.

Pixel mode (refinement=1): re-locate the target coordinate at the SAD minimum
of a 5x5 neighborhood of 16-byte small descriptors (matcher.cpp:1456-1496
relocateMinimum).

Formulation: instead of gathering a 16-byte descriptor at each of the 25
candidate positions (25*16 scattered loads per match), each match extracts
ONE gradient patch covering the whole search window per channel (the
`extract_patches` kernel), and the cost surface is assembled from 16 static
shifted slices of the patch.
"""

from __future__ import annotations

import torch

from .cuda_kernels import extract_patches
from .descriptors import SMALL_DU_OFFSETS, SMALL_DV_OFFSETS
from .matching import first_argmin

MARGIN = 6

# (channel, dx, dy) for all 16 small-descriptor samples; summation order is
# irrelevant for the SAD (matcher.cpp:490-505)
_SAMPLES = tuple((0, dx, dy) for dx, dy in SMALL_DU_OFFSETS) + tuple(
    (1, dx, dy) for dx, dy in SMALL_DV_OFFSETS)


def small_ref_descriptors(du1, dv1, u1, v1, count=None):
    """[16, M] f32 small descriptor (SAMPLE-MAJOR) at integer (u1, v1).

    One patch extraction with top-left (v1-2, u1-2); the 16 samples are
    static picks from the window. `count`: valid prefix length; rows at or
    past it come out as zeros."""
    iu1 = u1.to(torch.int32)
    iv1 = v1.to(torch.int32)
    pdu, pdv = extract_patches(du1, dv1, iu1 - 2, iv1 - 2, count)
    P = (pdu, pdv)
    return torch.stack(
        [P[ch][:, dy + 2, dx + 2] for ch, dx, dy in _SAMPLES], dim=0)


def _cost_surface_T(du1, dv1, du2, dv2, u1, v1, u2, v2, g: int, ref=None,
                    count=None):
    """[(2g+1)^2, M] SAD cost of the small descriptor at (u1,v1) in image 1
    vs positions (u2+du, v2+dv), |du|,|dv| <= g, in image 2. Candidate-major
    (rows ordered dv-major like the reference loops)."""
    iu2 = u2.to(torch.int32)
    iv2 = v2.to(torch.int32)
    if ref is None:
        ref = small_ref_descriptors(du1, dv1, u1, v1, count)
    r = g + 2  # descriptor samples reach +-2 around each candidate
    # fixed 16x16 window with top-left (v2-r, u2-r); sample (dy, dx) of
    # candidate (dv, du) sits at [dv+dy+r, du+dx+r] relative to top-left
    pdu, pdv = extract_patches(du2, dv2, iu2 - r, iv2 - r, count)
    return _surface_T_from_patches((pdu, pdv), ref, g, r - g)


def _surface_T_from_patches(P, ref, g: int, base: int):
    """[(2g+1)^2, M] SAD surface from pre-extracted window patches
    P = (pdu, pdv) [M, win, win] and sample-major ref [16, M]."""
    M = ref.shape[1]
    n = 2 * g + 1
    Pt = [x.permute(1, 2, 0) for x in P]  # [win, win, M]
    cost = torch.zeros((n, n, M), dtype=torch.float32, device=ref.device)
    for k, (ch, dx, dy) in enumerate(_SAMPLES):
        s = Pt[ch][base + dy: base + dy + n, base + dx: base + dx + n, :]
        cost = cost + (s - ref[k][None, None, :]).abs()
    return cost.reshape(n * n, M)


def relocate_minimum(du1, dv1, du2, dv2, u1, v1, u2, v2, w2, h2,
                     ref=None, count=None):
    """Vectorized relocateMinimum. Returns updated (u2, v2).

    Out-of-margin targets are left unchanged (matcher.cpp:1464-1465).
    `ref` optionally supplies precomputed small_ref_descriptors(du1, dv1,
    u1, v1) so callers refining several targets share one extraction;
    `count` is the valid-prefix length for the kernel's row gating."""
    m = float(MARGIN)
    feasible = ((u2 - 2 >= m) & (u2 + 2 <= w2 - 1 - m) &
                (v2 - 2 >= m) & (v2 + 2 <= h2 - 1 - m))
    costT = _cost_surface_T(du1, dv1, du2, dv2, u1, v1, u2, v2, 2, ref,
                            count)  # [25, M], dv-major rows
    best = first_argmin(costT, 0).to(torch.float32)
    du_off = torch.remainder(best, 5.0) - 2.0
    dv_off = torch.floor(best / 5.0) - 2.0
    return (torch.where(feasible, u2 + du_off, u2),
            torch.where(feasible, v2 + dv_off, v2))


def relocate_minimum_prefix(du1, dv1, du2, dv2, u1, v1, u2, v2, w2, h2,
                            window: int | None = None, ref=None, count=None):
    """relocate_minimum on the first `window` (compacted) matches only; the
    tail passes through unrefined (valid matches live in a prefix)."""
    n = u1.shape[0]
    if window is None or window >= n:
        return relocate_minimum(du1, dv1, du2, dv2, u1, v1, u2, v2, w2, h2,
                                ref, count)
    un, vn = relocate_minimum(du1, dv1, du2, dv2, u1[:window], v1[:window],
                              u2[:window], v2[:window], w2, h2, ref, count)
    return (torch.cat([un, u2[window:]]), torch.cat([vn, v2[window:]]))
