#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (`sfm_tpu_torch`).

    python3 chip_smoke.py

    python3 chip_smoke.py --profile    # the same, plus phase 6

Needs one NVIDIA GPU and `nvcc`; there is no CPU path, and without a GPU the
script exits non-zero and prints no result. It

  1. `device`:  prints the card (nvidia-smi name and power limit) and versions;
  2. `build`:   compiles sfm_tpu_torch/csrc/*.cu for sm_90a;
  3. `kernels`: holds each CUDA kernel against its plain PyTorch version on
     the card, exactly (torch.equal), at the shapes the stereo step gives it
     and at one odd shape each, and times both on the device (replays of a
     CUDA graph that holds the calls, so the host's cost per call is out);
  4. `stereo_step`: drives the fused stereo VO frame step through
     `make_stereo_frame_step` over 12 synthetic KITTI-shaped stereo frames
     (1241x376, default capacities, 200 RANSAC hypotheses), feeding the
     estimated motion back as the matching prior, and checks success, match
     count (above 1000 on every frame from the fourth on; above 900 on
     frames 1 to 3, where the prior is not settled yet and this scene's
     post-bucketing table holds fewer), translation within 5% of ground
     truth and the kernels' launch counts (4 / 8 / 4 per frame);
  5. `cpu_agreement`: frame 1 from the card against the same frame on
     `device="cpu"` with the same injected random draws;
  6. `profile` (only with `--profile`): the same frames again from the start
     under torch.profiler: host milliseconds of each `sfm/*` span of the
     step, GPU kernels launched per frame, summed device time and the
     device's idle share, and the device time per call of the three CUDA
     kernels. Traced frames run slower than untraced ones (the tracer's own
     cost per launch): read shares from it, and the frame time from phase 4.

Each phase prints one JSON line. Then come the nvidia-smi line, a
`{"kernels": [...]}` line with every kernel's launches, error, times and
bound, and the last line `{"ok": true, "device": {...}}`. Any failure raises:
nothing is caught, so a failed phase means a non-zero exit.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores;
                            # also used for the int32 / compare work
STEP_M = 0.8                # ground-truth forward motion per frame
BASELINE_M = 0.571
N_STEPS = 12
MIN_MATCHES = 1000          # post-bucketing table, every frame from the
SETTLED_FROM = 4            # fourth on; before it the floor below
MIN_MATCHES_EARLY = 900
WARMUP_STEPS = 2
PROFILE_STEPS = 8           # frames traced by --profile, after the warm-up
TR_TOL = 1e-3               # GPU vs CPU motion vector: f32 GN, sums in
                            # another order (same bound as the CPU tests)


def emit(obj):
    print(json.dumps(obj), flush=True)


def _event_ms(run, per, rounds):
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / per)
    return float(np.median(out))


def device_ms(fn, reps, rounds=5):
    """Device time of one call of `fn`: `reps` calls are captured into one
    CUDA graph and the graph is replayed, so the host's cost of a call
    (Python, ctypes, the dispatcher) is not in the reading; the gaps between
    a graph's nodes are. Median over `rounds` replays, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps, rounds)


def call_ms(fn, reps, rounds=5):
    """Time of one eager call of `fn` as a caller sees it, host cost
    included: `reps` back-to-back calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _event_ms(run, reps, rounds)


def as_count_tensor(count, device):
    """An int count as a device tensor (an int would be copied from the host
    at every call, which a graph capture does not take)."""
    if count is None or torch.is_tensor(count):
        return count
    return torch.tensor(int(count), dtype=torch.int32, device=device)


def max_abs_err(got, want):
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def require_equal(got, want, what):
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version (max abs err {max_abs_err([g], [w])})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_detect_filters(ck, images):
    """images: {label: (u8 image, with_blob_checker)}; the first two are the
    main path's shapes."""
    import torch.nn.functional as F

    rows = []
    for label, (img, full) in images.items():
        got = ck.detect_filters(img, with_blob_checker=full)
        want = ck.detect_filters_plain(img, with_blob_checker=full)
        require_equal(got, want, f"detect_filters {label}")
        H, W = img.shape
        n_out = 2 + (4 if full else 0)
        ops_px = 55 if full else 32   # separable form: passes + packs
        bytes_ms = H * W * (1 + n_out) / HBM_BYTES_PER_S * 1e3
        ops_ms = H * W * ops_px / FP32_OPS_PER_S * 1e3
        # yardstick: one float32 conv2d with the same 5x5 taps (2 or 4
        # output channels); it leaves out the shift/clip pack
        imgf = img.float()[None, None]
        wts = torch.randn(4 if full else 2, 1, 5, 5, device=img.device)
        rows.append(dict(
            shape=f"{H}x{W}" + (",full" if full else ",sobel"),
            max_abs_err=max_abs_err(got, want),
            ms=device_ms(lambda: ck.detect_filters(img, full), 50),
            call_ms=call_ms(lambda: ck.detect_filters(img, full), 50),
            plain_ms=device_ms(lambda: ck.detect_filters_plain(img, full), 5),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=device_ms(lambda: F.conv2d(imgf, wts, padding=2), 20)))
    return rows


def sad_args(src, dst, prior, radius=100.0, disp_tol=2.0, n_valid2=None):
    """Arguments of one stereo-like pass from `src` to `dst`; `n_valid2`
    shortens the candidates' valid prefix (tables are compacted)."""
    f = lambda x: x.to(torch.float32)
    u, v = f(src.u), f(src.v)
    neg = torch.full_like(u, -1.0)
    valid2 = dst.valid
    if n_valid2 is not None:
        valid2 = valid2 & (torch.arange(valid2.shape[0], device=valid2.device)
                           < n_valid2)
    return (f(src.desc), src.cls, u - radius, u + radius, v - disp_tol,
            v + disp_tol, u if prior else neg, v if prior else neg,
            f(dst.desc), f(dst.u), f(dst.v), dst.cls, valid2)


def check_sad_argmin(ck, matching, cases):
    """cases: {label: (args, valid1, count1, count2)}."""
    rows = []
    for label, (args, valid1, count1, count2) in cases.items():
        idx, cost = ck.sad_argmin(*args, valid1=valid1, count1=count1,
                                  count2=count2)
        pidx, pcost = matching.sad_argmin_pass(*args)
        N1, N2 = args[0].shape[0], args[8].shape[0]
        live = torch.ones(N1, dtype=torch.bool, device=idx.device)
        if valid1 is not None:
            live &= valid1
        if count1 is not None:
            live &= torch.arange(N1, device=idx.device) < count1
        # live rows: same winner and bit-equal cost, the no-match cost being
        # MIN_COST_INIT in the kernel and the masked fill in the plain
        # version; dead rows: the no-match result
        want_idx = torch.where(live, pidx, torch.zeros_like(pidx))
        want_cost = torch.where(live, pcost.clamp(max=matching.MIN_COST_INIT),
                                torch.full_like(pcost, matching.MIN_COST_INIT))
        require_equal((idx, cost), (want_idx, want_cost),
                      f"sad_argmin {label}")
        # work these inputs need: a mask test for every (live row, candidate
        # in the prefix), a 32-element SAD (+ prior) for each pair that passes
        n2 = N2 if count2 is None else min(int(count2), N2)
        kernel = lambda: ck.sad_argmin(*args, valid1=valid1, count1=count1,
                                       count2=count2)
        d1, c1, umn, umx, vmn, vmx, tu, tv, d2, u2, v2, c2, valid2 = args
        pairs = 0
        for s in range(0, N1, 512):
            e = min(s + 512, N1)
            mask = (valid2[None] & (c2[None] == c1[s:e, None])
                    & (u2[None] >= umn[s:e, None]) & (u2[None] <= umx[s:e, None])
                    & (v2[None] >= vmn[s:e, None]) & (v2[None] <= vmx[s:e, None])
                    & live[s:e, None])
            pairs += int(mask.sum())
        n_live = int(live.sum())
        ops = n_live * n2 * 6 + pairs * (64 + 8)
        # bytes these inputs need: descriptor, class and six bounds of each
        # live row, descriptor, position, class and validity of each candidate
        # in the prefix, the row gate, and both outputs for every row
        nbytes = (n_live * (32 * 4 + 7 * 4) + n2 * (32 * 4 + 3 * 4 + 1)
                  + (N1 if valid1 is not None else 0) + N1 * 8)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        rows.append(dict(
            shape=f"{N1}x{N2},{label}", live_rows=n_live, candidates=n2,
            pairs_in_mask=pairs,
            max_abs_err=max_abs_err((idx, cost), (want_idx, want_cost)),
            ms=device_ms(kernel, 50), call_ms=call_ms(kernel, 50),
            plain_ms=device_ms(lambda: matching.sad_argmin_pass(*args), 2,
                               rounds=3),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None))
    return rows


def check_extract_patches(ck, du, dv, cases):
    """cases: {label: (u0, v0, count)}."""
    rows = []
    for label, (u0, v0, count) in cases.items():
        got = ck.extract_patches(du, dv, u0, v0, count)
        want = ck.extract_patches_plain(du, dv, u0, v0, count)
        require_equal(got, want, f"extract_patches {label}")
        M = u0.shape[0]
        cnt = M if count is None else min(int(count), M)
        tcount = as_count_tensor(count, u0.device)
        kernel = lambda: ck.extract_patches(du, dv, u0, v0, tcount)
        nbytes = 2 * cnt * 256 + 2 * M * 256 * 4 + 2 * M * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * cnt * 256 / FP32_OPS_PER_S * 1e3   # u8 -> f32 converts
        rows.append(dict(
            shape=f"M={M},count={cnt}",
            max_abs_err=max_abs_err(got, want),
            ms=device_ms(kernel, 50), call_ms=call_ms(kernel, 50),
            plain_ms=device_ms(
                lambda: ck.extract_patches_plain(du, dv, u0, v0, tcount), 5),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None))
    return rows


def profile_frames(drive, fresh_state, n_frames):
    """The step's frames again from the start: WARMUP_STEPS untraced, then
    `n_frames` under torch.profiler. Returns the breakdown per frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = fresh_state()
    drive(1, WARMUP_STEPS, state)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = drive(WARMUP_STEPS + 1, WARMUP_STEPS + n_frames, state)
    # raw events: the `sfm/*` spans appear once on the host and once on the
    # device timeline, so they are told apart from kernels by name
    stages, kern_ms, kern_n = {}, {}, {}
    for e in prof.events():
        span = e.name.startswith("sfm/")
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == DeviceType.CPU and span:
            stages[e.name] = stages.get(e.name, 0.0) + ms / n_frames
        elif e.device_type == DeviceType.CUDA and not span:
            kern_ms[e.name] = kern_ms.get(e.name, 0.0) + ms
            kern_n[e.name] = kern_n.get(e.name, 0) + 1
    if not kern_ms:
        raise AssertionError("profile: the profiler reported no device time")
    busy_ms = sum(kern_ms.values()) / n_frames
    frame_ms = float(np.median(traced_ms))

    def own(short):
        names = [k for k in kern_n if short in k]
        calls = sum(kern_n[k] for k in names)
        return dict(calls_per_frame=calls / n_frames,
                    us_per_call=1e3 * sum(kern_ms[k] for k in names) / max(1, calls))

    top = sorted(kern_ms, key=kern_ms.get, reverse=True)[:15]
    return dict(
        frames_traced=n_frames, ms_per_frame_traced_median=frame_ms,
        stages_host_ms_per_frame=dict(sorted(stages.items(),
                                             key=lambda kv: -kv[1])),
        device_busy_ms_per_frame=busy_ms,
        device_idle_share=1.0 - busy_ms / frame_ms,
        launches_per_frame=sum(kern_n.values()) / n_frames,
        port_kernels_device={k: own(k + "_kernel") for k in
                             ("detect_filters", "sad_argmin", "extract_patches")},
        top_kernels=[dict(name=k[:90], calls_per_frame=kern_n[k] / n_frames,
                          ms_per_frame=kern_ms[k] / n_frames) for k in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help=f"also trace {PROFILE_STEPS} frames with "
                         "torch.profiler and print the breakdown")
    profile_steps = PROFILE_STEPS if ap.parse_args().profile else 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        sys.exit(1)

    # the port: nothing of JAX, nothing of the JAX package
    from sfm_tpu_torch.config import (Bucketing, Calibration, EngineConfig,
                                      StereoParams)
    from sfm_tpu_torch.convert import to_numpy
    from sfm_tpu_torch.models.pipeline import make_stereo_frame_step
    from sfm_tpu_torch.ops import cuda_kernels as ck
    from sfm_tpu_torch.ops import filters, matching
    from sfm_tpu_torch.ops.se3 import transformation_vector_to_matrix
    from sfm_tpu_torch.utils.synthetic import SceneConfig, make_sequence

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # --- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # --- 2. build ----------------------------------------------------------
    build_s = ck.build(force=True)
    emit({"phase": "build", "seconds": build_s, "sources": list(ck.SOURCES),
          "flags": list(ck.NVCC_FLAGS)})

    # --- frames and the step ------------------------------------------------
    scene = SceneConfig()
    w, h = scene.width, scene.height
    t0 = time.perf_counter()
    left, right, poses = make_sequence(N_STEPS + 1, scene, step=STEP_M,
                                       baseline=BASELINE_M)
    render_s = time.perf_counter() - t0
    params = StereoParams(
        calib=Calibration(f=scene.f, cu=scene.cu, cv=scene.cv),
        base=BASELINE_M, bucket=Bucketing(max_features=1000))
    engine = EngineConfig()
    step = make_stereo_frame_step(w, h, params, engine)   # on the GPU
    first_l, first_r = step.detect(left[0]), step.detect(right[0])
    torch.cuda.synchronize()

    # --- 3. kernels --------------------------------------------------------
    rs = np.random.RandomState(0)
    img_full = torch.from_numpy(left[0]).to(dev)
    img_half = filters.half_resolution(img_full, h // 2, w // 2)
    img_odd = torch.from_numpy(rs.randint(0, 256, (101, 203)).astype(np.uint8)).to(dev)
    k1 = check_detect_filters(ck, {
        "half": (img_half, True), "full": (img_full, False),
        "odd": (img_odd, True), "odd_sobel": (img_odd, False)})

    def rand_set(n, n_valid):
        """A compacted feature table of random descriptors, some duplicated
        so that equal costs occur."""
        from sfm_tpu_torch.ops.nms import FeatureSet

        desc = rs.randint(0, 256, (n, 32)).astype(np.uint8)
        desc[1::7] = desc[0]
        t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dev, dt)
        return FeatureSet(
            u=t(rs.randint(0, 300, n), torch.int32),
            v=t(rs.randint(0, 8, n), torch.int32),
            val=t(np.zeros(n), torch.int32),
            cls=t(rs.randint(0, 4, n), torch.int32),
            valid=t(np.arange(n) < n_valid, torch.bool),
            count=t(n_valid, torch.int32), desc=t(desc, torch.uint8))

    odd_src, odd_dst = rand_set(1000, 900), rand_set(777, 700)
    sl, sr = first_l.sparse, first_r.sparse
    dl, dr = first_l.dense, first_r.dense
    k2 = check_sad_argmin(ck, matching, {
        "dense,prior,counts": (sad_args(dl, dr, True), dl.valid, dl.count, dr.count),
        "sparse,prior,counts": (sad_args(sl, sr, True), sl.valid, sl.count, sr.count),
        "dense,noprior,nocounts": (sad_args(dl, dr, False), None, None, None),
        "sparse,noprior,nocounts": (sad_args(sl, sr, False), None, None, None),
        "dense,prior,partial": (sad_args(dl, dr, True, n_valid2=dr.count // 2),
                                None, dl.count // 2, dr.count // 2),
        "odd,prior,counts": (sad_args(odd_src, odd_dst, True, radius=60.0),
                             odd_src.valid, odd_src.count, odd_dst.count),
        "odd,noprior,nocounts": (sad_args(odd_src, odd_dst, False, radius=60.0),
                                 None, None, None)})

    def corners(m):
        t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
        # windows over the whole image, its borders and beyond included
        return t(rs.randint(-20, w + 20, m)), t(rs.randint(-20, h + 20, m))

    rw = min(engine.refine_window, engine.max_matches)
    u0a, v0a = corners(rw)
    u0b, v0b = corners(777)
    k3 = check_extract_patches(ck, first_l.du_full, first_l.dv_full, {
        "window": (u0a, v0a, torch.tensor(1500, dtype=torch.int32, device=dev)),
        "odd": (u0b, v0b, None),
        "odd,count": (u0b, v0b, 500)})
    emit({"phase": "kernels", "ok": True, "comparison": "torch.equal",
          "detect_filters": k1, "sad_argmin": k2, "extract_patches": k3})

    # --- 4. stereo_step ----------------------------------------------------
    draws = torch.Generator().manual_seed(1)
    r_bucket = torch.rand(engine.max_matches, generator=draws)
    u_ransac = torch.rand(params.ransac_iters, 3, generator=draws)

    def drive(first, last, state, on_frame=None):
        """Frames first..last through the step, the estimated motion fed back
        as the next frame's prior. Frame 1 takes the injected draws (it is
        compared with the CPU in phase 5). Returns host ms per frame."""
        out = []
        for i in range(first, last + 1):
            rand = (dict(r_bucket=r_bucket, u_ransac=u_ransac) if i == 1
                    else dict(generator=state["gen"]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["l"], state["r"], m, res = step(
                state["l"], state["r"], left[i], right[i], state["trp"], **rand)
            ok = bool(res.success)
            if ok:
                state["trp"] = transformation_vector_to_matrix(res.tr)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            if on_frame is not None:
                on_frame(i, m, res, ok, out[-1])
        return out

    def fresh_state():
        return dict(l=first_l, r=first_r,
                    trp=torch.eye(4, dtype=torch.float32, device=dev),
                    gen=torch.Generator(device=dev).manual_seed(0))

    per_frame, problems, frame1 = [], [], []
    seen = {}

    def check_frame(i, m, res, ok, ms):
        if i == 1:
            frame1.append((to_numpy(m), to_numpy(res)))
        now = ck.launch_counts()
        delta = {k: now[k] - seen[k] for k in now}
        seen.update(now)
        tr = res.tr.cpu().numpy()
        dist = float(np.linalg.norm(tr[3:6]))
        n_matches = int(res.n_matches)
        per_frame.append(dict(frame=i, success=ok, matches=n_matches,
                              inliers=int(res.n_inliers), ms=ms,
                              translation_m=dist, launches=delta))
        if not np.all(np.isfinite(tr)):
            problems.append(f"frame {i}: non-finite motion {tr}")
        if not ok:
            problems.append(f"frame {i}: motion estimate failed")
        if n_matches <= (MIN_MATCHES if i >= SETTLED_FROM
                         else MIN_MATCHES_EARLY):
            problems.append(f"frame {i}: {n_matches} matches")
        if abs(dist - STEP_M) > 0.05 * STEP_M:
            problems.append(f"frame {i}: translation {dist} m, ground truth "
                            f"{STEP_M} m")
        if delta != {"detect_filters": 4, "sad_argmin": 8,
                     "extract_patches": 4}:
            problems.append(f"frame {i}: kernel launches {delta}")

    ck.reset_launch_counts()
    seen.update(ck.launch_counts())
    drive(1, N_STEPS, fresh_state(), check_frame)
    launches = ck.launch_counts()
    matches_median = float(np.median([f["matches"] for f in per_frame]))
    timed = [f["ms"] for f in per_frame[WARMUP_STEPS:]]
    emit({"phase": "stereo_step", "ok": not problems, "size": [w, h],
          "frames": per_frame, "render_seconds": render_s,
          "matches_median": matches_median,
          "ms_per_frame_median": float(np.median(timed)),
          "ms_per_frame_min": float(np.min(timed)),
          "ms_per_frame_max": float(np.max(timed)),
          "launches": launches})
    if problems:
        raise AssertionError("stereo_step: " + "; ".join(problems))

    # --- 5. cpu_agreement --------------------------------------------------
    t0 = time.perf_counter()
    cpu_step = make_stereo_frame_step(w, h, params, engine, device="cpu")
    _, _, cm, cres = cpu_step(cpu_step.detect(left[0]), cpu_step.detect(right[0]),
                              left[1], right[1], torch.eye(4),
                              r_bucket=r_bucket, u_ransac=u_ransac)
    gm, gres = frame1[0]
    for name in gm._fields:
        if not np.array_equal(getattr(gm, name), getattr(cm, name).numpy()):
            raise AssertionError(f"cpu_agreement: match table field {name} "
                                 "differs between the GPU and the CPU")
    tr_err = float(np.abs(gres.tr - cres.tr.numpy()).max())
    if int(gres.n_inliers) != int(cres.n_inliers) or tr_err > TR_TOL:
        raise AssertionError(f"cpu_agreement: inliers {int(gres.n_inliers)} "
                             f"vs {int(cres.n_inliers)}, tr error {tr_err}")
    if ck.launch_counts() != launches:
        raise AssertionError("the CPU step launched a CUDA kernel")
    emit({"phase": "cpu_agreement", "ok": True, "matches": int(cres.n_matches),
          "tr_max_abs_err": tr_err, "tr_tol": TR_TOL,
          "seconds": time.perf_counter() - t0})

    # --- 6. profile (optional) ---------------------------------------------
    if profile_steps:
        emit(dict(phase="profile", card=smi,
                  **profile_frames(drive, fresh_state, profile_steps)))

    # --- the record ----------------------------------------------------------
    def entry(name, source, replaces, rows):
        first, rest = rows[0], rows[1:]
        return dict(name=name, route="cuda",
                    source=f"sfm_tpu_torch/csrc/{source}", replaces=replaces,
                    launches=launches[name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=first["ms"], call_ms=first["call_ms"],
                    plain_ms=first["plain_ms"],
                    bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                    library_ms=first["library_ms"], shape=first["shape"],
                    other_shapes=rest)

    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: not launched by the main path")
    emit({"phase": "done", "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [
        entry("detect_filters", "detect_filters.cu",
              "sfm_tpu/ops/pallas_kernels.py:442", k1),
        entry("sad_argmin", "sad_argmin.cu",
              "sfm_tpu/ops/pallas_kernels.py:188", k2),
        entry("extract_patches", "extract_patches.cu",
              "sfm_tpu/ops/pallas_kernels.py:321", k3)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
