"""Matcher: feature detection + the quad circular matching closure.

Counterpart of the reference Matcher class (viso/matcher.{h,cpp}) as plain
functions on fixed-capacity tables: feature detection per image, and the
quad circle closure prev-left -> prev-right -> cur-right -> cur-left ->
prev-left as four chained SAD-argmin passes with index gathers in between.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import filters
from ..ops.cuda_kernels import detect_filters
from ..ops.descriptors import compute_descriptors
from ..ops.matching import (Matches, RangeTable, compact_matches,
                            lookup_ranges, sad_argmin)
from ..ops.nms import FeatureSet, empty_feature_set, nms_features, sparse_nms_n


class FrameFeatures(NamedTuple):
    """Features + gradients for one image of one frame."""

    sparse: FeatureSet     # 1st-pass features, full-resolution coords
    dense: FeatureSet      # 2nd-pass features, full-resolution coords
    du_full: torch.Tensor  # full-res Sobel x-gradient (uint8)
    dv_full: torch.Tensor  # full-res Sobel y-gradient (uint8)
    img: torch.Tensor      # original image (uint8), for gain estimation


def detect_features(
    img: torch.Tensor,
    *,
    w: int,
    h: int,
    nms_n: int,
    nms_tau: int,
    multi_stage: int,
    half_resolution: int,
    cap_sparse: int,
    cap_dense: int,
) -> FrameFeatures:
    """computeFeatures equivalent (matcher.cpp:649-732): filter the matching-
    resolution image, run sparse+dense NMS, gather descriptors, scale
    coordinates to full resolution."""
    if half_resolution:
        wm, hm = w // 2, h // 2
        img_m = filters.half_resolution(img, hm, wm)
        s = 2
    else:
        wm, hm = w, h
        img_m = img
        s = 1

    # one fused filter pass per image and resolution (computeFeatures as a
    # single kernel, matcher.cpp:649-732)
    du_m, dv_m, f1, f2 = detect_filters(img_m, with_blob_checker=True)
    du_full, dv_full = (detect_filters(img, with_blob_checker=False)
                        if half_resolution else (du_m, dv_m))

    def detect(n, cap):
        fs = nms_features(f1, f2, w=wm, h=hm, n=n, tau=nms_tau, cap=cap)
        desc = compute_descriptors(du_m, dv_m, fs.u, fs.v)
        return fs._replace(u=fs.u * s, v=fs.v * s, desc=desc)

    if multi_stage:
        sparse = detect(sparse_nms_n(nms_n), cap_sparse)
    else:
        sparse = empty_feature_set(cap_sparse, img.device)
    dense = detect(nms_n, cap_dense)
    return FrameFeatures(sparse, dense, du_full, dv_full, img)


# ---------------------------------------------------------------------------
# Matching passes (quad circle closure)
# ---------------------------------------------------------------------------

def _bin_of(u, v, binsize, nbu, nbv):
    bu = torch.floor(u.to(torch.float32) / binsize).to(torch.int32).clamp(0, nbu - 1)
    bv = torch.floor(v.to(torch.float32) / binsize).to(torch.int32).clamp(0, nbv - 1)
    return bv * nbu + bu


def _bounds(u_src, v_src, stat_bin, rt: Optional[RangeTable], stage: int,
            flow: bool, radius: float, disp_tol: float):
    """Search bounds for one pass (matcher.cpp:907-928)."""
    u = u_src.to(torch.float32)
    v = v_src.to(torch.float32)
    if rt is None:
        u_min, u_max = u - radius, u + radius
        v_min, v_max = v - radius, v + radius
    else:
        lo_u, hi_u, lo_v, hi_v = lookup_ranges(rt, stat_bin, stage)
        u_min, u_max = u + lo_u, u + hi_u
        v_min, v_max = v + lo_v, v + hi_v
    if not flow:
        v_min, v_max = v - disp_tol, v + disp_tol
    return u_min, u_max, v_min, v_max


def _pass(src: FeatureSet, dst: FeatureSet, stat_bin, rt, stage, flow,
          radius, disp_tol, t_u=None, t_v=None, row_count=None):
    """row_count: valid-prefix length of the ROW space. For gathered source
    sets (rows aligned to the closure's base table, not prefix-compacted in
    their own right) pass the base table's count: src.count would be the
    gather SOURCE's count, which is the wrong axis."""
    n = src.u.shape[0]
    if t_u is None:
        t_u = torch.full((n,), -1.0, dtype=torch.float32, device=src.u.device)
        t_v = t_u
    u_min, u_max, v_min, v_max = _bounds(src.u, src.v, stat_bin, rt, stage,
                                         flow, radius, disp_tol)
    idx, _ = sad_argmin(
        src.desc.to(torch.float32), src.cls,
        u_min, u_max, v_min, v_max, t_u, t_v,
        dst.desc.to(torch.float32),
        dst.u.to(torch.float32), dst.v.to(torch.float32),
        dst.cls, dst.valid, valid1=src.valid,
        count1=row_count, count2=dst.count,
    )
    return idx


def _gather_feats(fs: FeatureSet, idx) -> FeatureSet:
    """Row-gather of the feature table by match indices."""
    i = idx.long()
    return FeatureSet(
        u=fs.u[i], v=fs.v[i], val=fs.val[i], cls=fs.cls[i],
        valid=fs.valid[i], count=fs.count, desc=fs.desc[i],
    )


def match_quad(
    p1: FeatureSet, p2: FeatureSet, c1: FeatureSet, c2: FeatureSet,
    rt: Optional[RangeTable], tr: Optional[torch.Tensor],
    calib: Optional[torch.Tensor],
    *, w: int, h: int, binsize: int, nbu: int, nbv: int,
    radius: float, disp_tol: float, cap: int, use_rt: bool, use_tr: bool,
) -> Matches:
    """Quad circle closure prev-left -> prev-right -> cur-right -> cur-left ->
    prev-left (matcher.cpp:1088-1153), with Tr_delta match prediction
    (matcher.cpp:1114-1131)."""
    rt = rt if use_rt else None
    n = p1.u.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=p1.u.device)
    stat_bin = _bin_of(p1.u, p1.v, binsize, nbu, nbv)

    i2p = _pass(p1, p2, stat_bin, rt, 0, False, radius, disp_tol,
                row_count=p1.count)
    p2_sel = _gather_feats(p2, i2p)

    if use_tr:
        fl, cu, cv, base = calib[0], calib[1], calib[2], calib[3]
        u1p = p1.u.to(torch.float32)
        v1p = p1.v.to(torch.float32)
        u2p = p2_sel.u.to(torch.float32)
        d = (u1p - u2p).clamp(min=1.0)
        x1p = (u1p - cu) * base / d
        y1p = (v1p - cv) * base / d
        z1p = fl * base / d
        x2c = tr[0, 0] * x1p + tr[0, 1] * y1p + tr[0, 2] * z1p + tr[0, 3] - base
        y2c = tr[1, 0] * x1p + tr[1, 1] * y1p + tr[1, 2] * z1p + tr[1, 3]
        z2c = tr[2, 0] * x1p + tr[2, 1] * y1p + tr[2, 2] * z1p + tr[2, 3]
        t_u2c = fl * x2c / z2c + cu
        t_v2c = fl * y2c / z2c + cv
        i2c = _pass(p2_sel, c2, stat_bin, rt, 1, True, radius, disp_tol,
                    t_u=t_u2c, t_v=t_v2c, row_count=p1.count)
    else:
        i2c = _pass(p2_sel, c2, stat_bin, rt, 1, True, radius, disp_tol,
                    row_count=p1.count)
    c2_sel = _gather_feats(c2, i2c)

    i1c = _pass(c2_sel, c1, stat_bin, rt, 2, False, radius, disp_tol,
                row_count=p1.count)
    c1_sel = _gather_feats(c1, i1c)

    if use_tr:
        i1p2 = _pass(c1_sel, p1, stat_bin, rt, 3, True, radius, disp_tol,
                     t_u=p1.u.to(torch.float32),
                     t_v=p1.v.to(torch.float32), row_count=p1.count)
    else:
        i1p2 = _pass(c1_sel, p1, stat_bin, rt, 3, True, radius, disp_tol,
                     row_count=p1.count)

    closed = (i1p2 == ar) & p1.valid & p2_sel.valid & c2_sel.valid & c1_sel.valid
    closed &= (p1.u >= p2_sel.u) & (c1_sel.u >= c2_sel.u)  # matcher.cpp:1146
    f = lambda x: x.to(torch.float32)
    m = Matches(
        u1p=f(p1.u), v1p=f(p1.v), i1p=ar,
        u2p=f(p2_sel.u), v2p=f(p2_sel.v), i2p=i2p,
        u1c=f(c1_sel.u), v1c=f(c1_sel.v), i1c=i1c,
        u2c=f(c2_sel.u), v2c=f(c2_sel.v), i2c=i2c,
        valid=closed, count=closed.sum().to(torch.int32),
    )
    return compact_matches(m, cap)
