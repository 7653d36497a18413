"""Stereo egomotion Gauss-Newton: batched residuals, Jacobians and solves.

Reference (viso/viso_stereo.cpp): RANSAC draws 3 stereo correspondences,
runs <=21 damped-free GN iterations on the 6-dof motion minimizing the 4-D
stereo reprojection error with the analytic Euler-derivative Jacobian
(computeResidualsAndJacobian, viso_stereo.cpp:225-315), counts 4-D
reprojection inliers (<2 px, getInlier :147-165), then refines on all
inliers (<=101 iterations, eps 1e-8).

Shape: the 200 hypotheses are a batch axis; each GN iteration is a batched
[B,3]-point Jacobian build + [B,6,6] solve. The final refinement is the
same code with one hypothesis and a weighted mask over all matches.
"""

from __future__ import annotations

import torch

from .linalg import solve_spd_small

# GN status codes (reference enum UPDATED/FAILED/CONVERGED)
UPDATED, FAILED, CONVERGED = 0, 1, 2


def rotation_and_derivatives(tr: torch.Tensor):
    """R(rx,ry,rz) and dR/drx, dR/dry, dR/drz exactly as written out in
    viso_stereo.cpp:236-246. tr: [..., 6]."""
    rx, ry, rz = tr[..., 0], tr[..., 1], tr[..., 2]
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    z = torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    R = mat([[cy * cz, -cy * sz, sy],
             [sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy],
             [-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz, cx * cy]])
    Rdx = mat([[z, z, z],
               [cx * sy * cz - sx * sz, -cx * sy * sz - sx * cz, -cx * cy],
               [sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy]])
    Rdy = mat([[-sy * cz, sy * sz, cy],
               [sx * cy * cz, -sx * cy * sz, sx * sy],
               [-cx * cy * cz, cx * cy * sz, -cx * sy]])
    Rdz = mat([[-cy * sz, -cy * cz, z],
               [-sx * sy * sz + cx * cz, -sx * sy * cz - cx * sz, z],
               [cx * sy * sz + sx * cz, cx * sy * cz - sx * sz, z]])
    return R, Rdx, Rdy, Rdz


def _rotate(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """out[..., m, i] = sum_j R[..., i, j] * pts[..., m, j], written out (the
    matrices are 3x3; a library batched product buys nothing here)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack(
        [R[..., None, i, 0] * x + R[..., None, i, 1] * y
         + R[..., None, i, 2] * z for i in range(3)], dim=-1)


def residuals_and_jacobian(tr, pts, obs, wmask, calib, reweighting=True):
    """tr [...,6]; pts [...,M,3] previous-frame 3D; obs [...,M,4]
    (u1c,v1c,u2c,v2c); wmask [...,M] 0/1 row mask; calib [f,cu,cv,base].

    Returns (J [...,M,4,6], resid [...,M,4], pred [...,M,4]); J and resid are
    multiplied by the reference's reweighting factor x row mask."""
    f, cu, cv, base = calib[0], calib[1], calib[2], calib[3]
    R, Rdx, Rdy, Rdz = rotation_and_derivatives(tr)
    t = tr[..., None, 3:6]  # [...,1,3]

    Xc = _rotate(R, pts) + t  # [...,M,3]
    X1c, Y1c, Z1c = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    X2c = X1c - base
    Z2 = Z1c * Z1c

    # reweighting 1/(|u1c-cu|/|cu| + 0.05), weight=1 when disabled
    # (viso_stereo.cpp:265-269, toggle viso_stereo.h:41)
    if reweighting:
        weight = 1.0 / ((obs[..., 0] - cu).abs() / cu.abs() + 0.05)
        weight = weight * wmask
    else:
        weight = wmask * torch.ones_like(obs[..., 0])

    # derivative of Xc wrt the 6 params: rotations act on pts, translations
    # are unit vectors (viso_stereo.cpp:278-294)
    dx_rot = _rotate(Rdx, pts)
    dx_rot = torch.cat([torch.zeros_like(dx_rot[..., :1]), dx_rot[..., 1:]],
                       dim=-1)
    dX_rot = torch.stack([dx_rot, _rotate(Rdy, pts), _rotate(Rdz, pts)],
                         dim=-1)  # [...,M,3,3(param)]
    eye = torch.eye(3, dtype=tr.dtype, device=tr.device).expand(
        dX_rot.shape[:-2] + (3, 3))
    dXc = torch.cat([dX_rot, eye], dim=-1)  # [...,M,3,6]
    X1cd = dXc[..., 0, :]
    Y1cd = dXc[..., 1, :]
    Z1cd = dXc[..., 2, :]

    w = (weight * f)[..., None]
    Ju1 = w * (X1cd * Z1c[..., None] - X1c[..., None] * Z1cd) / Z2[..., None]
    Jv1 = w * (Y1cd * Z1c[..., None] - Y1c[..., None] * Z1cd) / Z2[..., None]
    Ju2 = w * (X1cd * Z1c[..., None] - X2c[..., None] * Z1cd) / Z2[..., None]
    J = torch.stack([Ju1, Jv1, Ju2, Jv1], dim=-2)  # [...,M,4,6]; right v' == left v'

    pred = torch.stack([
        f * X1c / Z1c + cu,
        f * Y1c / Z1c + cv,
        f * X2c / Z1c + cu,
        f * Y1c / Z1c + cv,
    ], dim=-1)
    resid = weight[..., None] * (obs - pred)
    return J, resid, pred


def predict_observations(tr, pts, calib):
    """Predictions only (for inlier counting)."""
    f, cu, cv, base = calib[0], calib[1], calib[2], calib[3]
    R, _, _, _ = rotation_and_derivatives(tr)
    Xc = _rotate(R, pts) + tr[..., None, 3:6]
    X1c, Y1c, Z1c = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    return torch.stack([
        f * X1c / Z1c + cu,
        f * Y1c / Z1c + cv,
        f * (X1c - base) / Z1c + cu,
        f * Y1c / Z1c + cv,
    ], dim=-1)


def gn_solve(tr, pts, obs, wmask, calib, iters: int, eps: float,
             reweighting: bool = True):
    """Run the reference's iterate-until-converged loop with a static bound.

    Returns (tr, status [...]) where status follows the reference enum:
    CONVERGED only if the last solve's step was < eps everywhere
    (viso_stereo.cpp:96-102 / 115-131 semantics).

    The loop exits as soon as every batch element has converged or failed.
    Iterations run three to a check, like the JAX package's loop: elements
    that are no longer UPDATED are no-ops, so the grouping changes no result
    and a third of the host round trips for the exit test."""

    def one_iter(tr, status):
        J, resid, _ = residuals_and_jacobian(tr, pts, obs, wmask, calib,
                                             reweighting)
        Jf = J.reshape(J.shape[:-3] + (-1, 6))
        rf = resid.reshape(resid.shape[:-2] + (-1,))
        A = Jf.transpose(-1, -2) @ Jf
        b = (Jf.transpose(-1, -2) @ rf[..., None])[..., 0]
        x, solve_ok = solve_spd_small(A, b)
        active = status == UPDATED
        step_small = (x.abs() <= eps).all(dim=-1)
        new_tr = torch.where((active & solve_ok)[..., None], tr + x, tr)
        done = torch.where(step_small, CONVERGED, UPDATED)
        new_status = torch.where(
            active, torch.where(solve_ok, done, FAILED),
            status).to(torch.int32)
        return new_tr, new_status

    status = torch.zeros(tr.shape[:-1], dtype=torch.int32, device=tr.device)
    it = 0
    while it < iters and bool((status == UPDATED).any()):
        for _ in range(3):
            tr, status = one_iter(tr, status)
        it += 3
    return tr, status
