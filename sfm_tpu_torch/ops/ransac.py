"""Hypothesis-batched RANSAC sampling.

The reference loops sequential iterations of {draw k, solve, count inliers};
here the hypothesis axis is a batch dimension, so all samples are drawn at
once.
"""

from __future__ import annotations

import torch


def draw_samples(valid: torch.Tensor, iters: int, k: int,
                 u: torch.Tensor = None,
                 generator: torch.Generator = None) -> torch.Tensor:
    """[iters, k] distinct uniform indices of valid entries (replaces the
    fixed-seed Fisher-Yates prefix of viso.cpp:86-102, same uniform-k-subset
    distribution). Randomness is explicit: `u` holds the [iters, k] uniform
    draws in [0, 1), or `generator` is used to draw them.

    PRECONDITION: valid entries form a prefix (all match tables are
    compacted). Sequential sampling without replacement, vectorized over the
    hypothesis axis: draw r_j uniform in [0, count-j), then bump r_j past
    each previously chosen index in ascending order, which is exactly
    uniform over distinct k-subsets at O(iters * k^2) elementwise work
    (k <= 8). If count < k, indices clip into [0, count-1] and duplicates
    are unavoidable."""
    dev = valid.device
    if u is None:
        if generator is None:
            raise ValueError("draw_samples: pass the draws `u` or a "
                             "`generator`")
        u = torch.rand((iters, k), generator=generator, dtype=torch.float32,
                       device=generator.device)
    u = u.to(device=dev, dtype=torch.float32)
    if u.shape != (iters, k):
        raise ValueError(f"u: shape {tuple(u.shape)}, expected ({iters}, {k})")
    count = valid.sum().to(torch.int32)
    chosen = torch.zeros((iters, k), dtype=torch.int32, device=dev)
    for j in range(k):
        span = (count - j).clamp(min=1).to(torch.float32)
        r = torch.minimum((u[:, j] * span).to(torch.int32),
                          (count - j - 1).clamp(min=0))
        if j:
            prev = torch.sort(chosen[:, :j], dim=1).values
            for t in range(j):
                r = r + (r >= prev[:, t]).to(torch.int32)
        chosen[:, j] = r
    return torch.minimum(chosen.clamp(min=0), (count - 1).clamp(min=0))
