"""The fused stereo VO frame step.

One call per stereo frame, everything on one device: detect both images,
quad-match sparse then dense with per-bin range priors, kNN-vote outlier
removal, bucketing, pixel refinement, 3-point RANSAC + Gauss-Newton motion
estimate. Structure mirrors Matcher::matchFeatures +
VisualOdometryStereo::process (matcher.cpp:183-241, viso_stereo.cpp:33-40)
and the JAX package's `make_stereo_frame_step` default branch.

This slice of the port covers one configuration: outlier_mode "knnw"/"knn",
refinement 0 or 1, refine after bucketing, unbatched detect, no gain.
Anything else raises NotImplementedError; it never runs something else.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..config import EngineConfig, StereoParams
from ..ops.matching import (Matches, bucket_matches, compact_matches,
                            compute_prior_statistics)
from ..ops.outliers import knn_consistency_mask
from ..ops.refine import relocate_minimum_prefix, small_ref_descriptors
from .matcher import FrameFeatures, detect_features, match_quad
from .stereo import stereo_estimate_motion

_LATER = "not ported yet; see ROADMAP.md, Queue 1"


def _outliers(m: Matches, method: int, flow_tol: float, disp_tol: float,
              cap: int, mode: str = "knnw",
              engine: EngineConfig = None, limit: int = None) -> Matches:
    """Outlier filtering inside the fused step: on-device kNN-graph voting
    (Delaunay analog), weighted ("knnw") or not ("knn").

    `limit`: upper bound on the VALID match count (tables are compacted, so
    valid entries are a prefix). The sparse pass can never exceed the sparse
    feature capacity, so its [N, N] vote runs on a [limit, limit] slice."""
    if mode not in ("knn", "knnw"):
        raise NotImplementedError(f"outlier_mode={mode!r}: {_LATER}")
    e = engine or EngineConfig()
    n = m.u1c.shape[0]
    sl = (lambda a: a[:limit]) if (limit and limit < n) else (lambda a: a)
    flow_u, flow_v = m.u1c - m.u1p, m.v1c - m.v1p
    disp = (m.u1c - m.u2c) if method == 1 else (m.u1p - m.u2p)
    keep = knn_consistency_mask(
        sl(m.u1c), sl(m.v1c), sl(m.valid), sl(flow_u), sl(flow_v),
        sl(disp), method, flow_tol, disp_tol, k=e.outlier_knn_k,
        min_support=e.outlier_min_support, weighted=(mode == "knnw"))
    if keep.shape[0] != n:
        keep = torch.cat([keep, torch.zeros((n - keep.shape[0],),
                                            dtype=torch.bool,
                                            device=keep.device)])
    return compact_matches(m._replace(valid=keep), cap)


class StereoFrameStep(nn.Module):
    """Quad-matching stereo step:

        step(prev_l, prev_r: FrameFeatures, I1, I2, tr_prior [4,4],
             generator=... | r_bucket=..., u_ransac=...)
            -> (cur_l, cur_r, matches: Matches, result: StereoResult)

    The caller threads `cur_l`, `cur_r` back in as `prev_*` for the next
    frame (the matcher ring buffer, matcher.cpp:108-155, as explicit state);
    `detect(img)` makes the first frame's features.

    Randomness is explicit: pass a `torch.Generator`, or the uniform draws
    themselves (`r_bucket` [max_matches] for bucketing, `u_ransac`
    [ransac_iters, 3] for RANSAC sampling)."""

    def __init__(self, w: int, h: int, params: StereoParams,
                 engine: EngineConfig, device=None):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StereoFrameStep runs on the GPU and no CUDA device is "
                    "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        p = params.match
        if engine.outlier_mode not in ("knn", "knnw"):
            raise NotImplementedError(
                f"outlier_mode={engine.outlier_mode!r}: {_LATER}")
        if p.refinement not in (0, 1):
            raise NotImplementedError(f"refinement={p.refinement}: {_LATER}")
        for name in ("refine_pre_filter", "batched_detect", "compute_gain"):
            if getattr(engine, name):
                raise NotImplementedError(f"{name}=True: {_LATER}")
        self.w, self.h = int(w), int(h)
        self.params, self.engine = params, engine
        self.device = torch.device(device)
        radius = p.match_radius / 2 if p.half_resolution else p.match_radius
        self.nbu = -(-w // p.match_binsize)
        self.nbv = -(-h // p.match_binsize)
        self.radius = float(radius)
        self.register_buffer("calib4", torch.tensor(
            [params.calib.f, params.calib.cu, params.calib.cv, params.base],
            dtype=torch.float32, device=self.device))

    def _image(self, img) -> torch.Tensor:
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device).contiguous()

    @torch.no_grad()
    def detect(self, img) -> FrameFeatures:
        p, e = self.params.match, self.engine
        return detect_features(
            self._image(img), w=self.w, h=self.h, nms_n=p.nms_n,
            nms_tau=p.nms_tau, multi_stage=p.multi_stage,
            half_resolution=p.half_resolution,
            cap_sparse=e.max_features_sparse, cap_dense=e.max_features_dense)

    def _refine(self, m2: Matches, rw: int, cur_l, cur_r, prev_l, prev_r):
        # all three relocations share the same reference descriptor
        # (cur-left at u1c/v1c); extract it once: four patch extractions
        wf, hf = float(self.w), float(self.h)
        ref = small_ref_descriptors(cur_l.du_full, cur_l.dv_full,
                                    m2.u1c[:rw], m2.v1c[:rw], count=m2.count)
        u1p, v1p = relocate_minimum_prefix(
            cur_l.du_full, cur_l.dv_full, prev_l.du_full, prev_l.dv_full,
            m2.u1c, m2.v1c, m2.u1p, m2.v1p, wf, hf, window=rw, ref=ref,
            count=m2.count)
        u2c, v2c = relocate_minimum_prefix(
            cur_l.du_full, cur_l.dv_full, cur_r.du_full, cur_r.dv_full,
            m2.u1c, m2.v1c, m2.u2c, m2.v2c, wf, hf, window=rw, ref=ref,
            count=m2.count)
        u2p, v2p = relocate_minimum_prefix(
            cur_l.du_full, cur_l.dv_full, prev_r.du_full, prev_r.dv_full,
            m2.u1c, m2.v1c, m2.u2p, m2.v2p, wf, hf, window=rw, ref=ref,
            count=m2.count)
        return m2._replace(u1p=u1p, v1p=v1p, u2c=u2c, v2c=v2c,
                           u2p=u2p, v2p=v2p)

    @torch.no_grad()
    def forward(self, prev_l: FrameFeatures, prev_r: FrameFeatures, I1, I2,
                tr_prior: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                r_bucket: Optional[torch.Tensor] = None,
                u_ransac: Optional[torch.Tensor] = None):
        params, engine = self.params, self.engine
        p = params.match
        if generator is None and (r_bucket is None or u_ransac is None):
            raise ValueError("randomness is explicit: pass `generator`, or "
                             "both `r_bucket` and `u_ransac`")
        kw = dict(w=self.w, h=self.h, binsize=p.match_binsize, nbu=self.nbu,
                  nbv=self.nbv, radius=self.radius,
                  disp_tol=float(p.match_disp_tolerance),
                  cap=engine.max_matches)
        mode = engine.outlier_mode
        tr_prior = tr_prior.to(device=self.device, dtype=torch.float32)

        # the spans name the stages in a torch.profiler trace and cost
        # nothing measurable outside one
        with record_function("sfm/detect"):
            cur_l, cur_r = self.detect(I1), self.detect(I2)
        with record_function("sfm/match_sparse"):
            m1 = match_quad(prev_l.sparse, prev_r.sparse, cur_l.sparse,
                            cur_r.sparse, None, tr_prior, self.calib4,
                            use_rt=False, use_tr=True, **kw)
        with record_function("sfm/outliers_sparse"):
            m1 = _outliers(m1, 2, p.outlier_flow_tolerance,
                           p.outlier_disp_tolerance, engine.max_matches, mode,
                           engine, limit=engine.max_features_sparse)
        with record_function("sfm/prior_statistics"):
            rt = compute_prior_statistics(
                m1, method=2, n_bins_u=self.nbu, n_bins_v=self.nbv,
                binsize=p.match_binsize, match_radius=self.radius)
        with record_function("sfm/match_dense"):
            m2 = match_quad(prev_l.dense, prev_r.dense, cur_l.dense,
                            cur_r.dense, rt, tr_prior, self.calib4,
                            use_rt=True, use_tr=True, **kw)
        with record_function("sfm/outliers_dense"):
            m2 = _outliers(m2, 2, p.outlier_flow_tolerance,
                           p.outlier_disp_tolerance, engine.max_matches, mode,
                           engine)
        # bucketing compacts into a refine_window-capacity table: the window
        # must cover every post-filter match anyway (config.py note), and the
        # smaller table halves the row work of refinement and of the whole
        # estimate stage (RANSAC scoring, final GN)
        cap_pb = min(engine.refine_window, engine.max_matches)
        with record_function("sfm/bucket"):
            m2 = bucket_matches(m2, params.bucket.max_features,
                                params.bucket.bucket_width,
                                params.bucket.bucket_height, cap_pb,
                                r=r_bucket, generator=generator)
        # refine AFTER filtering/bucketing: only the survivors
        if p.refinement > 0:
            with record_function("sfm/refine"):
                m2 = self._refine(m2, cap_pb, cur_l, cur_r, prev_l, prev_r)
        with record_function("sfm/estimate_motion"):
            res = stereo_estimate_motion(
                m2, self.calib4, float(params.inlier_threshold),
                ransac_iters=params.ransac_iters,
                reweighting=params.reweighting, u=u_ransac,
                generator=generator)
        return cur_l, cur_r, m2, res


def make_stereo_frame_step(w: int, h: int, params: StereoParams,
                           engine: EngineConfig,
                           device=None) -> StereoFrameStep:
    """The stereo frame step as an `nn.Module`. `device=None` means the GPU
    and raises when there is none; only an explicit `device="cpu"` runs on
    the CPU (with the kernels' plain versions)."""
    return StereoFrameStep(w, h, params, engine, device=device)
