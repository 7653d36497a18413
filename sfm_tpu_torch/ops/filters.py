"""Image filters (equivalents of reference viso/filter.{h,cpp}).

The reference implements 5x5 Sobel, 5x5 blob and 5x5 checkerboard filters
over `uint8` images, producing:
  * Sobel gradients as uint8: ``sat((response >> 7) + 128)``
    (filter.cpp:71-127: scale 1/128, bias +128, unsigned saturation),
  * blob / checkerboard responses as int16 (filter.cpp:331-365).

The integer semantics are reproduced exactly (arithmetic shift = floor
division, saturating u8 pack) with centered windows. torch `uint8`
arithmetic wraps, so every stage computes in int32 and casts at the end.

These are the plain versions: `ops/cuda_kernels.py::detect_filters` fuses
all of them into one CUDA kernel and is held bit-equal to them.

Borders: outputs are full-size and wrap around (`torch.roll`); values
within 2 px of the border are invalid by contract (the feature extractor
never reads closer than ``margin = 6`` from the border, matcher.cpp:56,344-345).
"""

from __future__ import annotations

import torch

SMOOTH5 = (1, 4, 6, 4, 1)      # 14641 smoothing tap (filter.cpp:71)
DERIV5 = (1, 2, 0, -2, -1)     # 12021 derivative tap (filter.cpp:105)
CHECKER5 = (1, 1, 0, -1, -1)   # checkerboard tap (filter.cpp:235,260)
ONES5 = (1, 1, 1, 1, 1)
ONES3 = (1, 1, 1)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = in[y + dy, x + dx]; borders wrap (invalid, inside margin)."""
    return torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))


def _sep_pass(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Apply a centered 1-D tap along `axis` (0=y, 1=x) via shifted adds."""
    r = len(taps) // 2
    out = None
    for i, c in enumerate(taps):
        if c == 0:
            continue
        d = i - r
        s = _shift(x, d, 0) if axis == 0 else _shift(x, 0, d)
        term = s if c == 1 else (-s if c == -1 else c * s)
        out = term if out is None else out + term
    return out


def _pack_u8(acc: torch.Tensor, shift_amount: int) -> torch.Tensor:
    """(acc >> s) + 128, saturate to [0, 255] (filter.cpp:94-98 semantics)."""
    v = torch.bitwise_right_shift(acc, shift_amount) + 128
    return v.clamp(0, 255).to(torch.uint8)


def sobel5x5(img: torch.Tensor):
    """5x5 Sobel. Returns (I_du, I_dv) uint8.

    I_du = x-derivative (column-smoothed), I_dv = y-derivative (row-smoothed);
    matches reference filter::sobel5x5 output ordering (filter.cpp:316-324).
    Sign convention follows the reference taps: +1 weight on the -2 side.
    """
    x = img.to(torch.int32)
    tv = _sep_pass(x, SMOOTH5, axis=0)   # column smoothing
    th = _sep_pass(x, DERIV5, axis=0)    # column derivative
    du = _sep_pass(tv, DERIV5, axis=1)   # row derivative
    dv = _sep_pass(th, SMOOTH5, axis=1)  # row smoothing
    return _pack_u8(du, 7), _pack_u8(dv, 7)


def blob5x5(img: torch.Tensor) -> torch.Tensor:
    """5x5 blob filter, int16 response (filter.cpp:338-365).

    Kernel: -1 on the 5x5 ring, +1 on the 3x3 ring, +8 center, computed as
    ``-(5x5 box) + 2*(3x3 box) + 7*center`` like the reference's
    integral-image formulation (filter.cpp:357-362).
    """
    x = img.to(torch.int32)
    box5 = _sep_pass(_sep_pass(x, ONES5, 0), ONES5, 1)
    box3 = _sep_pass(_sep_pass(x, ONES3, 0), ONES3, 1)
    acc = -box5 + 2 * box3 + 7 * x
    return acc.to(torch.int16)


def checkerboard5x5(img: torch.Tensor) -> torch.Tensor:
    """5x5 checkerboard filter, int16 response (filter.cpp:326-336).

    Separable [1,1,0,-1,-1] x [1,1,0,-1,-1] (quadrant contrast)."""
    x = img.to(torch.int32)
    t = _sep_pass(x, CHECKER5, axis=0)
    acc = _sep_pass(t, CHECKER5, axis=1)
    return acc.to(torch.int16)


def half_resolution(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """2x2 box downsample with floor division (matcher.cpp:636-647)."""
    x = img[: 2 * out_h, : 2 * out_w].to(torch.int32)
    s = x.reshape(out_h, 2, out_w, 2).sum(dim=(1, 3))
    return (s // 4).to(torch.uint8)
