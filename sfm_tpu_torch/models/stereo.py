"""Stereo visual odometry: 3-point RANSAC + Gauss-Newton refinement.

VisualOdometryStereo::estimateMotion (reference viso_stereo.cpp:42-145) as
one function on tensors: stereo triangulation of previous-frame points, 200
GN hypotheses as a batch axis, inlier counting as one [B, N] pass, final GN
over the best inlier set with the reference's convergence contract.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.matching import Matches, first_argmin
from ..ops.ransac import draw_samples
from ..ops.stereo_gn import CONVERGED, FAILED, gn_solve, predict_observations


class StereoResult(NamedTuple):
    tr: torch.Tensor
    success: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    n_matches: torch.Tensor
    # frame-to-frame camera gain ratio (matcher.cpp:286-324); not computed
    # by the port yet
    gain: Optional[torch.Tensor] = None


def stereo_estimate_motion(
    m: Matches,
    calib: torch.Tensor,            # [f, cu, cv, base]
    inlier_threshold: float,
    *,
    ransac_iters: int,
    reweighting: bool = True,
    u: torch.Tensor = None,         # [ransac_iters, 3] uniform draws, or
    generator: torch.Generator = None,
) -> StereoResult:
    valid = m.valid
    N = valid.sum().to(torch.int32)
    okN = N >= 6  # viso_stereo.cpp:56-58

    f, cu, cv, base = calib[0], calib[1], calib[2], calib[3]
    # previous-frame 3D from disparity (viso_stereo.cpp:70-75)
    d = (m.u1p - m.u2p).clamp(min=0.0001)
    X = (m.u1p - cu) * base / d
    Y = (m.v1p - cv) * base / d
    Z = f * base / d
    pts = torch.stack([X, Y, Z], dim=-1)                      # [N, 3]
    obs = torch.stack([m.u1c, m.v1c, m.u2c, m.v2c], dim=-1)   # [N, 4]

    # --- RANSAC over 3-point hypotheses (viso_stereo.cpp:86-112) ---
    samples = draw_samples(valid, ransac_iters, 3, u=u,
                           generator=generator).long()       # [B, 3]
    pts_s = pts[samples]                                      # [B, 3, 3]
    obs_s = obs[samples]
    ones = torch.ones(samples.shape, dtype=pts.dtype, device=pts.device)
    tr0 = torch.zeros((ransac_iters, 6), dtype=pts.dtype, device=pts.device)
    tr_h, status_h = gn_solve(tr0, pts_s, obs_s, ones, calib, 21, 1e-6,
                              reweighting)

    pred = predict_observations(tr_h, pts[None], calib)       # [B, N, 4]
    err2 = ((obs[None] - pred) ** 2).sum(dim=-1)
    inl = (err2 < inlier_threshold * inlier_threshold) & valid[None, :]
    inl = inl & (status_h != FAILED)[:, None]
    counts = inl.sum(dim=1).to(torch.int32)
    best = first_argmin(-counts, 0)   # first hypothesis with the most inliers
    best_mask = inl[best]
    n_in = counts[best]
    ok_in = n_in >= 6  # viso_stereo.cpp:115

    # --- final refinement on all inliers (viso_stereo.cpp:115-131) ---
    # reference eps is 1e-8 in double; in float32 GN steps bottom out near
    # 1e-7, so 1e-6 is used (still ~0.1 um / 0.1 urad, far below pixel noise)
    wmask = best_mask.to(pts.dtype)
    tr_f, status_f = gn_solve(tr_h[best], pts, obs, wmask, calib, 101, 1e-6,
                              reweighting)
    ok_conv = status_f == CONVERGED

    success = okN & ok_in & ok_conv & torch.isfinite(tr_f).all()
    # identity motion on failure (never NaN)
    tr_f = torch.where(success, tr_f, torch.zeros_like(tr_f))
    return StereoResult(tr=tr_f, success=success, inliers=best_mask,
                        n_inliers=n_in, n_matches=N)
