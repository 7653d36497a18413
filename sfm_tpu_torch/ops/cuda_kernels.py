"""Hand-written CUDA kernels of the matcher hot loops, and their wrappers.

The counterpart of the JAX package's `ops/pallas_kernels.py`. The sources are
CUDA C++ under `csrc/`, compiled for `sm_90a` by `nvcc` at first use (one
`nvcc -c` per source, all started together, then one link) into
`csrc/build/libsfm_kernels.so` with a plain C interface, loaded with ctypes.

Every wrapper
  * checks device, dtype, shape and contiguity and raises on what the
    kernel does not take;
  * launches on `torch.cuda.current_stream()`; the kernel allocates nothing
    and does not synchronise (outputs come from `torch.empty` here);
  * raises if the launch reports an error (`cudaGetLastError()` is the C
    function's return value);
  * adds one to its launch count where it launches, and nowhere else;
  * takes the plain PyTorch version ONLY for tensors on the CPU. Given a CUDA
    tensor it launches the kernel or raises; nothing falls back.

Kernels and their plain versions:
  detect_filters  <-> detect_filters_plain          (ops/filters.py arithmetic)
  sad_argmin      <-> ops/matching.py::sad_argmin_pass
  extract_patches <-> extract_patches_plain
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from . import filters

PATCH = 16  # fixed window size; covers the 9x9 (pixel) / 13x13 (subpixel) need

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = ("detect_filters.cu", "sad_argmin.cu", "extract_patches.cu")
LIB_NAME = "libsfm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# launches per kernel since the last reset (plain ints)
_launches = {"detect_filters": 0, "sad_argmin": 0, "extract_patches": 0}
_lib = None


def launch_counts() -> dict:
    """Copy of the per-kernel launch counts."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# ---------------------------------------------------------------------------
# Build + load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False) -> float:
    """Compile csrc/*.cu into csrc/build/libsfm_kernels.so. Returns the
    seconds spent (0.0 when the library is already newer than its sources)."""
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    lib = os.path.join(BUILD_DIR, LIB_NAME)
    if (not force and os.path.exists(lib)
            and all(os.path.getmtime(lib) >= os.path.getmtime(s)
                    for s in srcs)):
        return 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + ".o")
            for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    for s, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s}:\n{log}")
    tmp = lib + f".{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, LIB_NAME))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sfm_detect_filters.argtypes = [P, I, I, I, P, P, P, P, P]
        lib.sfm_sad_argmin.argtypes = [P] * 16 + [I, I, P, P, P]
        lib.sfm_extract_patches.argtypes = [P, P, I, I, P, P, P, I, P, P, P]
        for fn in (lib.sfm_detect_filters, lib.sfm_sad_argmin,
                   lib.sfm_extract_patches):
            fn.restype = I
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _count_tensor(count, device):
    """None, int or 0-d / 1-element integer tensor -> i32 device tensor or
    None (the kernel then uses the table capacity). A tensor made here may be
    freed right after the launch: the caching allocator hands its memory out
    again in stream order, so the kernel has read it by then."""
    if count is None:
        return None
    if not torch.is_tensor(count):
        return torch.tensor(int(count), dtype=torch.int32, device=device)
    if count.numel() != 1:
        raise ValueError("count must hold one element")
    return count.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")


# ---------------------------------------------------------------------------
# Kernel 1: fused detect filters
# ---------------------------------------------------------------------------

def detect_filters_plain(img: torch.Tensor, with_blob_checker: bool = True):
    """The filters of ops/filters.py one after the other: (du, dv) u8 and,
    with `with_blob_checker`, (blob, checker) i16."""
    du, dv = filters.sobel5x5(img)
    if not with_blob_checker:
        return du, dv
    return du, dv, filters.blob5x5(img), filters.checkerboard5x5(img)


def detect_filters(img: torch.Tensor, with_blob_checker: bool = True):
    """One pass over a [H, W] u8 image producing every detect-stage filter
    response with the exact integer semantics of ops/filters.py, borders
    wrapped included. Returns (du, dv[, blob, checker]).

    Replaces `detect_filters_pallas` of the JAX package. Memory-bound on the
    GPU; the kernel is a shared-memory tiled stencil and takes any size."""
    if not img.is_cuda:
        return detect_filters_plain(img, with_blob_checker)
    if img.dim() != 2:
        raise ValueError(f"img: expected [H, W], got {tuple(img.shape)}")
    H, W = img.shape
    _check(img, "img", torch.uint8, (H, W), img.device)
    with torch.cuda.device(img.device):
        du = torch.empty((H, W), dtype=torch.uint8, device=img.device)
        dv = torch.empty_like(du)
        blob = chk = None
        if with_blob_checker:
            blob = torch.empty((H, W), dtype=torch.int16, device=img.device)
            chk = torch.empty_like(blob)
        err = _library().sfm_detect_filters(
            img.data_ptr(), H, W, int(with_blob_checker), du.data_ptr(),
            dv.data_ptr(), _ptr(blob), _ptr(chk), _stream())
    _raise_on(err, "detect_filters")
    _launches["detect_filters"] += 1
    return (du, dv, blob, chk) if with_blob_checker else (du, dv)


# ---------------------------------------------------------------------------
# Kernel 2: masked SAD argmin
# ---------------------------------------------------------------------------

def sad_argmin(d1, c1, u_min, u_max, v_min, v_max, t_u, t_v,
               d2, u2, v2, c2, valid2, valid1=None, count1=None, count2=None):
    """One directed matching pass: (best_idx [N1] i32, best_cost [N1] f32).

    Same contract as ops/matching.py::sad_argmin_pass on every live row,
    with the no-match cost reported as MIN_COST_INIT (the plain version
    reports the masked fill). Rows at or past `count1`, or with `valid1`
    false, are not scanned and get the no-match result (index 0); candidates
    at or past `count2` are not looked at (tables are compacted, so they are
    invalid anyway).

    Replaces `sad_argmin_pallas` of the JAX package: one warp per source
    row, mask before SAD, first-index argmin by a (cost, index) reduction."""
    if not d1.is_cuda:
        from .matching import sad_argmin_pass

        return sad_argmin_pass(d1, c1, u_min, u_max, v_min, v_max, t_u, t_v,
                               d2, u2, v2, c2, valid2)
    dev = d1.device
    if d1.dim() != 2 or d2.dim() != 2:
        raise ValueError("d1, d2: expected [N, 32]")
    N1, N2 = d1.shape[0], d2.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(d1, "d1", f32, (N1, 32), dev)
    _check(d2, "d2", f32, (N2, 32), dev)
    if d2.data_ptr() % 16:
        raise ValueError("d2: must be 16-byte aligned")
    _check(c1, "c1", i32, (N1,), dev)
    for name, t in (("u_min", u_min), ("u_max", u_max), ("v_min", v_min),
                    ("v_max", v_max), ("t_u", t_u), ("t_v", t_v)):
        _check(t, name, f32, (N1,), dev)
    _check(u2, "u2", f32, (N2,), dev)
    _check(v2, "v2", f32, (N2,), dev)
    _check(c2, "c2", i32, (N2,), dev)
    _check(valid2, "valid2", (torch.bool, torch.uint8), (N2,), dev)
    if valid1 is not None:
        _check(valid1, "valid1", (torch.bool, torch.uint8), (N1,), dev)
    with torch.cuda.device(dev):
        cnt1 = _count_tensor(count1, dev)
        cnt2 = _count_tensor(count2, dev)
        idx = torch.empty((N1,), dtype=i32, device=dev)
        cost = torch.empty((N1,), dtype=f32, device=dev)
        err = _library().sfm_sad_argmin(
            d1.data_ptr(), c1.data_ptr(), u_min.data_ptr(), u_max.data_ptr(),
            v_min.data_ptr(), v_max.data_ptr(), t_u.data_ptr(),
            t_v.data_ptr(), _ptr(valid1), _ptr(cnt1), d2.data_ptr(),
            u2.data_ptr(), v2.data_ptr(), c2.data_ptr(), valid2.data_ptr(),
            _ptr(cnt2), N1, N2, idx.data_ptr(), cost.data_ptr(), _stream())
    _raise_on(err, "sad_argmin")
    _launches["sad_argmin"] += 1
    return idx, cost


# ---------------------------------------------------------------------------
# Kernel 3: patch extraction (match refinement windows)
# ---------------------------------------------------------------------------

def _live_count(count, M: int, device):
    if count is None:
        return M
    if torch.is_tensor(count):
        return count.to(device).reshape(()).clamp(max=M)
    return min(int(count), M)


def extract_patches_plain(du, dv, u0, v0, count=None):
    """[M, PATCH, PATCH] f32 windows of du/dv with top-left (v0, u0) per
    match: the top-left is clipped into the image, positions past (H, W)
    read as zero, rows at or past `count` are all zero."""
    H, W = du.shape
    M = u0.shape[0]
    dev = du.device
    uc = u0.to(torch.int64).clamp(0, W - 1)
    vc = v0.to(torch.int64).clamp(0, H - 1)
    off = torch.arange(PATCH, device=dev)
    ys = vc[:, None] + off[None, :]                       # [M, P]
    xs = uc[:, None] + off[None, :]
    inside = (ys < H)[:, :, None] & (xs < W)[:, None, :]  # [M, P, P]
    idx = (ys.clamp(max=H - 1)[:, :, None] * W
           + xs.clamp(max=W - 1)[:, None, :])
    live = torch.arange(M, device=dev) < _live_count(count, M, dev)
    keep = inside & live[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def take(img):
        return torch.where(keep, img.reshape(-1)[idx].to(torch.float32), zero)

    return take(du), take(dv)


def extract_patches(du, dv, u0, v0, count=None):
    """Windows of the two u8 gradient images for a table of matches; see
    `extract_patches_plain` for the contract.

    Replaces `extract_patches_pallas` of the JAX package: a plain indexed
    copy, one block per match, bound by the f32 output bytes."""
    if not du.is_cuda:
        return extract_patches_plain(du, dv, u0, v0, count)
    dev = du.device
    if du.dim() != 2 or u0.dim() != 1:
        raise ValueError("du: expected [H, W]; u0: expected [M]")
    H, W = du.shape
    M = u0.shape[0]
    _check(du, "du", torch.uint8, (H, W), dev)
    _check(dv, "dv", torch.uint8, (H, W), dev)
    _check(u0, "u0", torch.int32, (M,), dev)
    _check(v0, "v0", torch.int32, (M,), dev)
    with torch.cuda.device(dev):
        cnt = _count_tensor(count, dev)
        pdu = torch.empty((M, PATCH, PATCH), dtype=torch.float32, device=dev)
        pdv = torch.empty_like(pdu)
        err = _library().sfm_extract_patches(
            du.data_ptr(), dv.data_ptr(), H, W, u0.data_ptr(), v0.data_ptr(),
            _ptr(cnt), M, pdu.data_ptr(), pdv.data_ptr(), _stream())
    _raise_on(err, "extract_patches")
    _launches["extract_patches"] += 1
    return pdu, pdv
