"""Batched small-matrix numerics.

The reference does its linear algebra with a scalar double-precision Matrix
class (Gauss-Jordan solves, matrix.cpp:424-512), invoked thousands of times
per frame inside RANSAC loops. Here those loops are batch axes, so what is
needed is *batched tiny* solves with identical control flow for every batch
element: fully unrolled elementwise arithmetic, no library factorisation.
"""

from __future__ import annotations

import torch


def solve_spd_small(A: torch.Tensor, b: torch.Tensor):
    """Batched solve for small SPD systems (n <= ~8) via fully unrolled
    Cholesky, branch-free elementwise math.

    Returns (x, ok) where ok=False marks non-SPD systems (the reference's
    Gauss-Jordan tiny-pivot FAILED signal, matrix.cpp:424-512).
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    ok = None
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        okj = s > 1e-20
        ok = okj if ok is None else ok & okj
        Ljj = torch.sqrt(s.clamp(min=1e-30))
        L[j][j] = Ljj
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t / Ljj
    y = [None] * n
    for i in range(n):
        t = b[..., i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t / L[i][i]
    xs = torch.stack(x, dim=-1)
    ok = ok & torch.isfinite(xs).all(dim=-1)
    return xs, ok


def inv3(M: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() > eps, det, torch.full_like(det, eps))
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([D, E, F], -1),
        torch.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def det3(M: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 determinant."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))
