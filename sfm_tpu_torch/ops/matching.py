"""Feature matching engine: masked SAD-argmin passes, prior search-range
statistics, circle closure, bucketing.

Data-parallel redesign of the reference matcher loops:
  * ``findMatch`` (matcher.cpp:892-963), a per-feature scan over candidate
    bins with SIMD SAD, becomes one *pass*: every source row scores every
    candidate feature, masked by search range + class, and takes a
    first-occurrence argmin. Default winner index 0 and the 1e7 cost cutoff
    reproduce the reference's ``min_ind=0`` / ``min_cost=10000000`` init.
  * ``computePriorStatistics`` (matcher.cpp:734-868) becomes per-bin min/max
    reductions into a [bins, stages, 4] range table.
  * bucketing (matcher.cpp:243-284) becomes a segmented random ranking.

Bin indexing in the reference only prunes the candidate scan; the exact
accept test is the coordinate-range check (matcher.cpp:943), which is what is
implemented, so results are bin-free. Tie-breaking differs only in candidate
*scan order* for exactly-equal SAD costs (smallest feature index here).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9
MIN_COST_INIT = 10000000.0  # matcher.cpp:899


class Matches(NamedTuple):
    """Fixed-capacity match table (mirrors Matcher::p_match, matcher.h:86-100).

    Invalid entries have valid=False; u/v are float32 full-resolution pixels.
    """

    u1p: torch.Tensor
    v1p: torch.Tensor
    i1p: torch.Tensor
    u2p: torch.Tensor
    v2p: torch.Tensor
    i2p: torch.Tensor
    u1c: torch.Tensor
    v1c: torch.Tensor
    i1c: torch.Tensor
    u2c: torch.Tensor
    v2c: torch.Tensor
    i2c: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


_FILLS = (-1.0, -1.0, -1, -1.0, -1.0, -1, -1.0, -1.0, -1, -1.0, -1.0, -1)


def empty_matches(cap: int, device=None) -> Matches:
    f = torch.full((cap,), -1.0, dtype=torch.float32, device=device)
    i = torch.full((cap,), -1, dtype=torch.int32, device=device)
    return Matches(f, f, i, f, f, i, f, f, i, f, f, i,
                   torch.zeros((cap,), dtype=torch.bool, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """argmin along `dim` that returns the LOWEST index among equal minima
    on every device (int64)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).view(shape)
    hit = x == x.amin(dim=dim, keepdim=True)
    return torch.where(hit, ar, n).amin(dim=dim).clamp(max=n - 1)


def compaction_gather_indices(ok: torch.Tensor, cap: int):
    """(src [cap] int64, count [] int32): src[s] = index of the s-th valid
    entry (clipped into range for slots past the count)."""
    n = ok.shape[0]
    c = torch.cumsum(ok.to(torch.int32), dim=0, dtype=torch.int32)
    count = c[n - 1].clamp(max=cap)
    slots = torch.arange(1, cap + 1, dtype=torch.int32, device=ok.device)
    src = torch.searchsorted(c, slots, right=False)
    return src.clamp(0, n - 1), count


def compact_matches(m: Matches, cap: int) -> Matches:
    """Pack valid entries to the front (deterministic, index order)."""
    src, count = compaction_gather_indices(m.valid, cap)
    live = torch.arange(cap, dtype=torch.int32, device=src.device) < count
    packed = [torch.where(live, f[src], torch.full((), fill, dtype=f.dtype,
                                                   device=f.device))
              for f, fill in zip(m[:12], _FILLS)]
    return Matches(*packed, valid=live, count=count)


# ---------------------------------------------------------------------------
# SAD argmin pass
# ---------------------------------------------------------------------------

def _sad_block(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences between descriptor rows: [M, N] float32.

    d1: [M, 32] float32, d2: [N, 32] float32 (u8 values, exact in f32).
    Structural equivalent of the 32-byte SIMD SAD (simd.hh:413-445).
    """
    return (d1[:, None, :] - d2[None, :, :]).abs().sum(-1)


def sad_argmin_pass(
    d1: torch.Tensor,        # [N1, 32] f32 source descriptors
    c1: torch.Tensor,        # [N1] i32 source classes
    u_min: torch.Tensor,     # [N1] f32 absolute search bounds
    u_max: torch.Tensor,
    v_min: torch.Tensor,
    v_max: torch.Tensor,
    t_u: torch.Tensor,       # [N1] f32 prior target (or -1: disabled)
    t_v: torch.Tensor,
    d2: torch.Tensor,        # [N2, 32] f32 candidate descriptors
    u2: torch.Tensor,        # [N2] f32 candidate coords
    v2: torch.Tensor,
    c2: torch.Tensor,        # [N2] i32
    valid2: torch.Tensor,    # [N2] bool
    chunk: int = 512,
):
    """One directed matching pass, the plain version of the `sad_argmin`
    kernel; returns (best_idx [N1] i32, best_cost [N1] f32).

    Cost = SAD + 4 * euclidean distance to the prior target when the target
    is enabled (matcher.cpp:946-953). Candidates outside the range/class or
    invalid get BIG; if nothing beats MIN_COST_INIT the winner index is 0
    (matcher.cpp:898-899 semantics). Materialises [chunk, N2] cost blocks.
    """
    N1 = d1.shape[0]
    valid2 = valid2.to(torch.bool)
    big = torch.full((), BIG, dtype=torch.float32, device=d1.device)
    zero = torch.zeros((), dtype=torch.float32, device=d1.device)
    idxs, bests = [], []
    for s in range(0, N1, chunk):
        e = min(s + chunk, N1)
        tu, tv = t_u[s:e], t_v[s:e]
        cost = _sad_block(d1[s:e], d2)  # [chunk, N2]
        use_t = (tu >= 0) & (tv >= 0)
        dist = torch.sqrt((u2[None, :] - tu[:, None]) ** 2 +
                          (v2[None, :] - tv[:, None]) ** 2)
        cost = cost + torch.where(use_t[:, None], 4.0 * dist, zero)
        mask = (
            valid2[None, :]
            & (c2[None, :] == c1[s:e, None])
            & (u2[None, :] >= u_min[s:e, None]) & (u2[None, :] <= u_max[s:e, None])
            & (v2[None, :] >= v_min[s:e, None]) & (v2[None, :] <= v_max[s:e, None])
        )
        cost = torch.where(mask, cost, big)
        best = cost.amin(dim=1)
        idx = first_argmin(cost, 1).to(torch.int32)
        idxs.append(torch.where(best < MIN_COST_INIT, idx, torch.zeros_like(idx)))
        bests.append(best)
    return torch.cat(idxs), torch.cat(bests)


def sad_argmin(d1, c1, u_min, u_max, v_min, v_max, t_u, t_v,
               d2, u2, v2, c2, valid2, valid1=None, count1=None, count2=None):
    """Dispatcher: the CUDA kernel for tensors on the GPU (no [N1, N2]
    materialisation, mask before SAD, count gating), `sad_argmin_pass` for
    tensors on the CPU. count1/count2: valid-prefix lengths (tables are
    compacted)."""
    from .cuda_kernels import sad_argmin as sad_argmin_kernel

    return sad_argmin_kernel(d1, c1, u_min, u_max, v_min, v_max, t_u, t_v,
                             d2, u2, v2, c2, valid2, valid1=valid1,
                             count1=count1, count2=count2)


# ---------------------------------------------------------------------------
# Search-range construction
# ---------------------------------------------------------------------------

class RangeTable(NamedTuple):
    """Per-bin search ranges for stages 0..3 (Matcher::range, matcher.h:151-157)."""

    u_min: torch.Tensor  # [n_bins, n_stages]
    u_max: torch.Tensor
    v_min: torch.Tensor
    v_max: torch.Tensor


def compute_prior_statistics(
    m: Matches,
    *,
    method: int,
    n_bins_u: int,
    n_bins_v: int,
    binsize: int,
    match_radius: float,
) -> RangeTable:
    """Per-bin displacement min/max over a 3x3 bin neighborhood
    (matcher.cpp:734-868), with the 20x20 minimum range floor."""
    n_stages = 4 if method == 2 else 2
    n_bins = n_bins_u * n_bins_v
    dev = m.u1c.device

    if method == 0:
        deltas = [(m.u1p - m.u1c, m.v1p - m.v1c), (m.u1c - m.u1p, m.v1c - m.v1p)]
        ref_u, ref_v = m.u1c, m.v1c
    elif method == 1:
        z = torch.zeros_like(m.u1c)
        deltas = [(m.u2c - m.u1c, z), (m.u1c - m.u2c, z)]
        ref_u, ref_v = m.u1c, m.v1c
    else:  # quad (matcher.cpp:778-785)
        z = torch.zeros_like(m.u1c)
        deltas = [
            (m.u2p - m.u1p, z),
            (m.u2c - m.u2p, m.v2c - m.v2p),
            (m.u1c - m.u2c, z),
            (m.u1p - m.u1c, m.v1p - m.v1c),
        ]
        ref_u, ref_v = m.u1p, m.v1p

    # centers intentionally unclipped: the reference clips the *ends* of the
    # [center-1, center+1] neighborhood (matcher.cpp:793-803), so off-grid
    # centers contribute to fewer bins, not shifted ones
    bu = torch.floor(ref_u / binsize).to(torch.int64)
    bv = torch.floor(ref_v / binsize).to(torch.int64)

    big = 1e6
    du_stack = torch.stack([d[0] for d in deltas], -1)  # [cap, S]
    dv_stack = torch.stack([d[1] for d in deltas], -1)

    # Per-bin min/max on a 1-padded bin grid, then the reference's clipped
    # +-1-bin accumulation (matcher.cpp:793-809) as a 3x3 neighborhood
    # min/max. Off-grid centers clip to the pad ring, which reproduces the
    # reference's end-clipping (a far-off center still feeds the nearest
    # edge bin). Invalid rows go to an extra bin that is dropped.
    gu = n_bins_u + 2
    gv = n_bins_v + 2
    bu_e = bu.clamp(-1, n_bins_u) + 1
    bv_e = bv.clamp(-1, n_bins_v) + 1
    bid = torch.where(m.valid, bv_e * gu + bu_e,
                      torch.full((), gv * gu, dtype=torch.int64, device=dev))
    bid_s = bid[:, None].expand(-1, n_stages)

    def bin_reduce(vals, mode):
        fill = big if mode == "min" else -big
        out = torch.full((gv * gu + 1, n_stages), fill, dtype=torch.float32,
                         device=dev)
        out.scatter_reduce_(0, bid_s, vals, "amin" if mode == "min" else "amax",
                            include_self=True)
        return out[:-1].reshape(gv, gu, n_stages)

    dmin_b = bin_reduce(du_stack, "min")
    dmax_b = bin_reduce(du_stack, "max")
    vmin_b = bin_reduce(dv_stack, "min")
    vmax_b = bin_reduce(dv_stack, "max")
    cnt_b = torch.bincount(bid, minlength=gv * gu + 1)[:-1].reshape(gv, gu)

    def neigh(x, mode):
        acc = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                s = torch.roll(x, (dy, dx), (0, 1))
                if acc is None:
                    acc = s
                elif mode == "min":
                    acc = torch.minimum(acc, s)
                elif mode == "max":
                    acc = torch.maximum(acc, s)
                else:
                    acc = acc + s
        return acc[1:-1, 1:-1]  # interior = real bins; pad ring absorbs wrap

    dmin = neigh(dmin_b, "min").reshape(n_bins, n_stages)
    dmax = neigh(dmax_b, "max").reshape(n_bins, n_stages)
    vmin = neigh(vmin_b, "min").reshape(n_bins, n_stages)
    vmax = neigh(vmax_b, "max").reshape(n_bins, n_stages)
    cnt = neigh(cnt_b, "sum").reshape(n_bins)

    has_obs = (cnt > 0)[:, None]
    r = torch.full((), float(match_radius), dtype=torch.float32, device=dev)
    dmin = torch.where(has_obs, dmin, -r)
    dmax = torch.where(has_obs, dmax, r)
    vmin = torch.where(has_obs, vmin, -r)
    vmax = torch.where(has_obs, vmax, r)

    # bound minimum search range to 20x20 (matcher.cpp:845-854)
    def floor20(lo, hi):
        d = hi - lo
        pad = torch.ceil((20.0 - d) / 2.0)
        grow = d < 20
        return torch.where(grow, lo - pad, lo), torch.where(grow, hi + pad, hi)

    dmin, dmax = floor20(dmin, dmax)
    vmin, vmax = floor20(vmin, vmax)
    return RangeTable(dmin, dmax, vmin, vmax)


def lookup_ranges(rt: RangeTable, stat_bin: torch.Tensor, stage: int):
    """Range-bound offsets for each row's stat bin."""
    sb = stat_bin.long()
    return (rt.u_min[sb, stage], rt.u_max[sb, stage],
            rt.v_min[sb, stage], rt.v_max[sb, stage])


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

def bucket_matches(
    m: Matches,
    max_features: int,
    bucket_width: float,
    bucket_height: float,
    cap: int,
    r: torch.Tensor = None,
    generator: torch.Generator = None,
) -> Matches:
    """Keep <= max_features random matches per (bucket_width x bucket_height)
    bucket of (u1c, v1c) (matcher.cpp:243-284).

    The reference shuffles each bucket with the global rand() and emits
    bucket-major; here the random keys are explicit, `r` ([n] uniform draws)
    or a `generator` to draw them from, and emission is in index order
    (downstream consumers are order-insensitive: RANSAC draws its own
    samples, GN keys on indices). The random rank within each bucket is one
    dense [n, n] compare + reduce.
    """
    n = m.u1c.shape[0]
    if max_features >= n:
        # keeps every match (the "disable bucketing" setting, main.cpp:71);
        # only emission order differs
        return compact_matches(m, cap)
    dev = m.u1c.device
    if r is None:
        if generator is None:
            raise ValueError("bucket_matches: pass the draws `r` or a "
                             "`generator`")
        r = torch.rand((n,), generator=generator, dtype=torch.float32,
                       device=generator.device)
    r = r.to(device=dev, dtype=torch.float32)
    if r.shape != (n,):
        raise ValueError(f"r: shape {tuple(r.shape)}, expected ({n},)")
    # bucket ids (cols from max coordinate, matcher.cpp:246-255)
    u_max = torch.where(m.valid, m.u1c, torch.zeros_like(m.u1c)).max()
    cols = torch.floor(u_max / bucket_width).to(torch.int32) + 1
    bu = torch.floor(m.u1c / bucket_width).to(torch.int32)
    bv = torch.floor(m.v1c / bucket_height).to(torch.int32)
    bid = torch.where(m.valid, bv * cols + bu,
                      torch.full((), 2 ** 30, dtype=torch.int32, device=dev))

    ar = torch.arange(n, dtype=torch.int32, device=dev)
    # rank of row i inside its bucket = count of same-bucket valid rows with
    # a strictly smaller (random, index) key
    same = bid[None, :] == bid[:, None]
    smaller = (r[None, :] < r[:, None]) | (
        (r[None, :] == r[:, None]) & (ar[None, :] < ar[:, None]))
    rank = (same & smaller & m.valid[None, :]).sum(dim=1)
    keep = m.valid & (rank < max_features)
    return compact_matches(
        m._replace(valid=keep, count=keep.sum().to(torch.int32)), cap)
