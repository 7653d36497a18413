"""Outlier removal via neighborhood consistency voting.

Reference (matcher.cpp:1207-1377): Delaunay-triangulate the current-left match
positions, then for every triangle edge check flow/disparity consistency and
give both endpoints a support vote; keep matches with >= 4 support.

This module holds the on-device analog: the symmetrized k-nearest-neighbor
graph stands in for the Delaunay graph, so the whole vote is dense tensor
work with no host triangulation.
"""

from __future__ import annotations

import torch


def _pairwise_agreement(flow_u, flow_v, disp, method, flow_tol, disp_tol):
    """[N, N] bool: matches i, j agree on flow/disparity within tolerance,
    the edge-consistency predicate of matcher.cpp:1280-1359 applied to every
    pair (the graph that selects WHICH pairs vote differs per filter)."""
    fok = ((flow_u[:, None] - flow_u[None, :]).abs()
           + (flow_v[:, None] - flow_v[None, :]).abs()) < flow_tol
    dok = (disp[:, None] - disp[None, :]).abs() < disp_tol
    if method == 0:
        return fok
    if method == 1:
        return dok
    return fok & dok


def knn_consistency_mask(
    u1c: torch.Tensor,
    v1c: torch.Tensor,
    valid: torch.Tensor,
    flow_u: torch.Tensor,
    flow_v: torch.Tensor,
    disp: torch.Tensor,
    method: int,
    flow_tol: float,
    disp_tol: float,
    k: int = 8,
    min_support: int = 4,
    weighted: bool = False,
) -> torch.Tensor:
    """On-device k-nearest-neighbor analog of the reference's Delaunay edge
    voting (matcher.cpp:1207-1377).

    The Delaunay graph connects each match to its ~6 Voronoi neighbors; an
    edge whose endpoints agree on flow/disparity gives both endpoints a vote
    (interior edges are visited once per adjacent triangle, i.e. counted
    twice), and matches with >= 4 votes survive. The symmetrized kNN graph
    (i-j is an edge iff j in kNN(i) or i in kNN(j)) is a close proxy for the
    Voronoi adjacency: like Delaunay, and unlike a fixed-radius disc, it
    adapts edge length to local density, so a wrong match must agree with
    its NEAREST neighbors specifically, not with any `min_support` matches
    in a wide disc.

    One [N, N] distance + agreement sweep plus an exact row-wise top-k.
    """
    du = u1c[:, None] - u1c[None, :]
    dv = v1c[:, None] - v1c[None, :]
    d2 = du * du + dv * dv
    n = u1c.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=u1c.device)
    off_graph = (~valid[None, :]) | (~valid[:, None]) | eye
    d2 = torch.where(off_graph, torch.full((), float("inf"), device=d2.device),
                     d2)
    # kth-smallest distance per row -> adjacency (ties admit extra neighbors,
    # harmless: ties in pixel distance are Delaunay-degenerate anyway)
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
    adj = (d2 <= kth) & ~off_graph
    agree = _pairwise_agreement(flow_u, flow_v, disp, method, flow_tol,
                                disp_tol)
    if weighted:
        # Delaunay-faithful vote weighting: the reference visits each edge
        # once per adjacent triangle, so interior edges vote TWICE and hull
        # edges once (matcher.cpp:1260-1369). Mutual-kNN edges are the
        # interior analog (weight 2); one-way edges the hull analog (1).
        w = ((adj & adj.T).to(torch.float32) * 2.0
             + (adj ^ adj.T).to(torch.float32))
        support = (w * agree.to(torch.float32)).sum(dim=1)
    else:
        edge = adj | adj.T
        support = (edge & agree).sum(dim=1)
    return valid & (support >= min_support)
