"""Parameter dataclasses of the engine (own copy of the JAX package's config).

Defaults mirror the reference parameter structs exactly:
  - Matcher::parameters        (reference viso/matcher.h:42-69)
  - VisualOdometry::calibration/bucketing/parameters (viso/viso.h:33-61)
  - VisualOdometryMono::parameters   (viso/viso_mono.h:32-45)
  - VisualOdometryStereo::parameters (viso/viso_stereo.h:32-43)
  - Reconstruction road-model constants (viso/reconstruction.cpp:34-48) are
    exposed as parameters here instead of being hardcoded.

Engine-specific additions (capacities for fixed-shape tables, toggles) are
grouped in `EngineConfig`. All tables in the engine are fixed-capacity with
validity masks; capacities here bound feature/match/track counts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MatcherParams:
    """Feature matching parameters (reference viso/matcher.h:42-69)."""

    nms_n: int = 3                   # non-max-suppression: min distance between maxima (px)
    nms_tau: int = 50                # non-max-suppression: interest point peakiness threshold
    match_binsize: int = 50          # matching bin width/height (affects efficiency only)
    match_radius: int = 200          # matching radius (du/dv in pixels)
    match_disp_tolerance: int = 2    # dv tolerance for stereo matches (px)
    outlier_disp_tolerance: int = 5  # outlier removal: disparity tolerance (px)
    outlier_flow_tolerance: int = 5  # outlier removal: flow tolerance (px)
    multi_stage: int = 1             # 0=disabled, 1=multistage matching (denser and faster)
    half_resolution: int = 1         # 0=disabled, 1=match at half res, refine at full res
    refinement: int = 1              # 0=none, 1=pixel, 2=subpixel
    # calibration (only used for stereo match prediction, matcher.h:54)
    f: float = 1.0
    cu: float = 0.0
    cv: float = 0.0
    base: float = 1.0


@dataclass(frozen=True)
class Calibration:
    """Camera intrinsics (reference viso/viso.h:33-42)."""

    f: float = 1.0    # focal length (px)
    cu: float = 0.0   # principal point u
    cv: float = 0.0   # principal point v


@dataclass(frozen=True)
class Bucketing:
    """Feature bucketing (reference viso/viso.h:45-54)."""

    max_features: int = 2
    bucket_width: float = 50.0
    bucket_height: float = 50.0


@dataclass(frozen=True)
class VoParams:
    """Common VO parameters (reference viso/viso.h:57-61)."""

    match: MatcherParams = field(default_factory=MatcherParams)
    bucket: Bucketing = field(default_factory=Bucketing)
    calib: Calibration = field(default_factory=Calibration)


@dataclass(frozen=True)
class MonoParams(VoParams):
    """Monocular VO parameters (reference viso/viso_mono.h:32-45)."""

    height: float = 1.0             # camera height above ground (m)
    pitch: float = 0.0              # camera pitch (rad, negative = down)
    ransac_iters: int = 2000
    inlier_threshold: float = 1e-5  # fundamental matrix Sampson threshold
    motion_threshold: float = 100.0 # return failure on small motions


@dataclass(frozen=True)
class StereoParams(VoParams):
    """Stereo VO parameters (reference viso/viso_stereo.h:32-43)."""

    base: float = 1.0               # baseline (m)
    ransac_iters: int = 200
    inlier_threshold: float = 2.0   # 4-D reprojection error threshold (px)
    reweighting: bool = True


@dataclass(frozen=True)
class ReconstructionParams:
    """Multi-frame reconstruction parameters.

    Reference hardcodes cam_pitch/-height inside setCalibration
    (viso/reconstruction.cpp:37-38); we expose them. Update-call defaults from
    viso/reconstruction.h:62 and the sfm demo call site (viso/sfm.hh:68).
    """

    cam_pitch: float = -0.08
    cam_height: float = 1.6
    point_type: int = 0             # 0=all, 1=road and above, 2=above road only
    min_track_length: int = 2
    max_dist: float = 30.0
    min_angle: float = 3.0          # degrees (sfm.hh:68 passes 3)
    max_track_length: int = 6       # reference viso/reconstruction.h:118


@dataclass(frozen=True)
class EngineConfig:
    """Engine capacities and toggles (no reference equivalent: the tables are
    fixed-shape tensors, so their sizes are configuration)."""

    # capacities (fixed table sizes; overflow beyond these is dropped)
    max_features_dense: int = 4096   # per image, dense (2nd) NMS pass
    max_features_sparse: int = 1024  # per image, sparse (1st) NMS pass
    max_matches: int = 4096          # per frame pair
    max_tracks: int = 4096           # live reconstruction tracks
    refine_window: int = 2048        # matches refined per frame (prefix of
                                     # the compacted match table). MUST cover
                                     # the post-filter match count: a smaller
                                     # window leaves half-res-quantized tail
                                     # coordinates in the estimator, which
                                     # degrades turning-scene accuracy. In
                                     # the STEREO fast path this is also the
                                     # post-bucket table capacity: matches
                                     # beyond it are DROPPED after bucketing
                                     # (set equal to max_matches to disable).
                                     # The MONO path always keeps the full
                                     # max_matches table
    refine_pre_filter: bool = False  # True = reference stage order (refine
                                     # ALL dense matches before the second
                                     # outlier pass, matcher.cpp:229-232);
                                     # False = fast path (refine the
                                     # post-bucket survivors only)
    # outlier removal implementation: "knnw" (on-device k-nearest-neighbor
    # vote with the reference's per-triangle double-count weighting, the
    # on-device Delaunay analog and the default), "knn" (unweighted
    # variant), "grid" (on-device radius-disc vote), or "delaunay" (host
    # callback, reference-faithful fidelity oracle, matcher.cpp:1207-1377)
    outlier_mode: str = "knnw"
    outlier_knn_k: int = 8           # neighbors per match in "knn" mode
    outlier_min_support: int = 4     # votes to survive ("knn"/"grid";
                                     # reference Delaunay uses 4 with interior
                                     # edges double-counted)
    outlier_grid_radius: float = 80.0  # neighbor disc radius in "grid" mode
    # compute the frame-to-frame camera gain ratio in the fused pipeline
    # (matcher.cpp:286-324 getGain; the class path exposes get_gain() instead)
    compute_gain: bool = False
    # stereo step: detect BOTH images in one batched program instead of two
    # sequential per-image detects; same results either way
    batched_detect: bool = False
    # float dtype for geometry (reference uses float64; f32 is device-native)
    dtype: str = "float32"


def replace(cfg, **kw):
    """dataclasses.replace that works on our frozen configs."""
    return dataclasses.replace(cfg, **kw)
