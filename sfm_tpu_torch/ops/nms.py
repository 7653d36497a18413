"""Non-maximum/minimum suppression feature detector.

The reference's Neubeck/Van Gool block NMS (matcher.cpp:330-431, "Efficient
Non-Maximum Suppression", ICPR'06 alg. 4) as data-parallel tensor code:

  * the image area ``[n+margin, dim-n-margin)`` is tiled by non-overlapping
    (n+1)x(n+1) blocks;
  * per block, the running min and max of the blob (f1) and checkerboard (f2)
    responses are found; ties keep the first element in the reference's
    scan order (x outer, y inner; matcher.cpp:356-380 uses strict
    comparisons);
  * each candidate is verified against the full (2n+1)^2 window clamped at
    ``dim-1-margin`` on the high side (matcher.cpp:383-389): it survives iff
    no strictly better value exists in the window;
  * minima must satisfy ``val <= -tau``, maxima ``val >= tau``
    (matcher.cpp:390,402) and are assigned classes 0..3:
    f1-min, f1-max, f2-min, f2-max (matcher.cpp:391-427).

Candidates land in fixed-capacity tables with a validity mask, compacted in
the reference's emission order (x-block major, so `u` ascends at block
granularity).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

MARGIN = 6  # descriptor + sobel margin (matcher.cpp:56)
_INF16 = 32767


class FeatureSet(NamedTuple):
    """Fixed-capacity feature tables (coordinates in matching resolution)."""

    u: torch.Tensor      # [cap] int32 x-coordinate
    v: torch.Tensor      # [cap] int32 y-coordinate
    val: torch.Tensor    # [cap] int32 filter response at the extremum
    cls: torch.Tensor    # [cap] int32 class 0..3
    valid: torch.Tensor  # [cap] bool
    count: torch.Tensor  # [] int32, number of valid features (<= cap)
    desc: torch.Tensor   # [cap, 32] uint8 descriptor (zeros until computed)


def empty_feature_set(cap: int, device=None) -> FeatureSet:
    z = torch.zeros((cap,), dtype=torch.int32, device=device)
    return FeatureSet(
        u=z, v=z, val=z, cls=z,
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        desc=torch.zeros((cap, 32), dtype=torch.uint8, device=device),
    )


def _block_extrema(region: torch.Tensor, nby: int, nbx: int, bs: int, mode: str):
    """Per-block (value, dy, dx) extrema with reference tie-breaking.

    region: [nby*bs, nbx*bs] int32. Tie order: x within block outer, y inner
    (matcher.cpp:356-357), first occurrence wins under strict comparison.
    """
    dev = region.device
    r = region.reshape(nby, bs, nbx, bs)  # [by, dy, bx, dx]
    dy = torch.arange(bs, dtype=torch.int32, device=dev).view(1, bs, 1, 1)
    dx = torch.arange(bs, dtype=torch.int32, device=dev).view(1, 1, 1, bs)
    t = dx * bs + dy  # scan order index, < bs*bs <= 121 < 128
    if mode == "min":
        k = (r * 128 + t).amin(dim=(1, 3))
        tt = torch.bitwise_and(k, 127)
    else:
        k = (r * 128 + (127 - t)).amax(dim=(1, 3))
        tt = 127 - torch.bitwise_and(k, 127)
    val = torch.bitwise_right_shift(k, 7)
    return val, tt % bs, tt // bs  # val, dy, dx per block [nby, nbx]


def _window_extreme(img: torch.Tensor, n: int, w: int, h: int, margin: int,
                    mode: str) -> torch.Tensor:
    """(2n+1)-window min/max with high-side clamping at dim-1-margin.

    Responses fit int16, so the pooling runs exactly in float32; positions
    past the clamp and past the image never win."""
    H, W = img.shape
    dev = img.device
    ys = torch.arange(H, device=dev).view(H, 1)
    xs = torch.arange(W, device=dev).view(1, W)
    sign = -1.0 if mode == "min" else 1.0
    x = img.to(torch.float32) * sign
    x = torch.where((ys > h - 1 - margin) | (xs > w - 1 - margin),
                    torch.full((), -float(_INF16), device=dev), x)
    pooled = F.max_pool2d(x[None, None], kernel_size=2 * n + 1, stride=1,
                          padding=n)[0, 0]
    return (pooled * sign).to(torch.int32)


def nms_features(f1: torch.Tensor, f2: torch.Tensor, *, w: int, h: int,
                 n: int, tau: int, margin: int = MARGIN,
                 cap: int = 4096) -> FeatureSet:
    """Extract interest points from blob (f1) / checkerboard (f2) responses.

    Tensors may be padded beyond (h, w); logical dims are ints.
    """
    from .matching import compaction_gather_indices

    dev = f1.device
    start = n + margin
    bs = n + 1
    nbx = (w - 2 * n - 2 * margin - 1) // bs + 1
    nby = (h - 2 * n - 2 * margin - 1) // bs + 1
    if nbx <= 0 or nby <= 0:
        return empty_feature_set(cap, dev)

    f1i = f1.to(torch.int32)
    f2i = f2.to(torch.int32)
    by = torch.arange(nby, dtype=torch.int32, device=dev).view(nby, 1)
    bx = torch.arange(nbx, dtype=torch.int32, device=dev).view(1, nbx)

    cand_u, cand_v, cand_val, cand_cls, cand_ok = [], [], [], [], []
    for cls, (img, mode) in enumerate(
        [(f1i, "min"), (f1i, "max"), (f2i, "min"), (f2i, "max")]
    ):
        region = img[start:start + nby * bs, start:start + nbx * bs]
        val, dy, dx = _block_extrema(region, nby, nbx, bs, mode)
        v = start + by * bs + dy
        u = start + bx * bs + dx
        wext = _window_extreme(img, n, w, h, margin, mode)
        at_cand = wext[v.long(), u.long()]
        if mode == "min":
            ok = (at_cand >= val) & (val <= -tau)
        else:
            ok = (at_cand <= val) & (val >= tau)
        cand_u.append(u)
        cand_v.append(v)
        cand_val.append(val)
        cand_cls.append(torch.full((nby, nbx), cls, dtype=torch.int32,
                                   device=dev))
        cand_ok.append(ok)

    # emission order: x-block major, y-block, then the 4 classes
    # (matcher.cpp:344-428 pushes f1min,f1max,f2min,f2max per (i,j) with the
    # i (x) loop outermost)
    def _order(stack):  # [4, nby, nbx] -> [nbx*nby*4]
        return torch.stack(stack).permute(2, 1, 0).reshape(-1)

    u_f = _order(cand_u)
    v_f = _order(cand_v)
    val_f = _order(cand_val)
    cls_f = _order(cand_cls)
    ok_f = _order(cand_ok)

    src, count = compaction_gather_indices(ok_f, cap)
    live = torch.arange(cap, dtype=torch.int32, device=dev) < count
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def _take(x):
        return torch.where(live, x[src], zero)

    return FeatureSet(
        u=_take(u_f),
        v=_take(v_f),
        val=_take(val_f),
        cls=_take(cls_f),
        valid=live,
        count=count,
        desc=torch.zeros((cap, 32), dtype=torch.uint8, device=dev),
    )


def sparse_nms_n(nms_n: int) -> int:
    """1st-pass (sparse) NMS neighborhood (matcher.cpp:685-687)."""
    n = nms_n * 3
    if n > 10:
        n = max(nms_n, 10)
    return n
