"""Feature descriptor gathers.

32-byte descriptor: Sobel du/dv samples at 16 fixed offsets around the feature
(reference matcher.cpp:433-477 computeDescriptor); 16-byte "small" ELAS
descriptor used by match refinement (matcher.cpp:479-506).

Implemented as vectorized flat gathers over the gradient images, one
[N, 16]-index gather per gradient channel. Descriptors are stored interleaved
(du, dv, du, dv, ...) in the exact reference byte order so SAD costs are
directly comparable.
"""

from __future__ import annotations

import torch

# (dx, dy) sample positions, in reference byte order for the large descriptor
# pairs; each position contributes a du byte then a dv byte
# (matcher.cpp:445-476: addr_m1=(u,v-1), m3=(u,v-3), m5=(u,v-5), p*=below).
DESC_OFFSETS = (
    (-3, -1), (-3, +1), (-1, -1), (-1, +1),
    (+3, -1), (+3, +1), (+1, -1), (+1, +1),
    (-1, -5), (-1, +5), (+1, -5), (+1, +5),
    (-5, -3), (-5, +3), (+5, -3), (+5, +3),
)

# small (ELAS) descriptor: 12 du samples then 4 dv samples
# (matcher.cpp:490-505; note du[addr2]=(0,0) appears twice).
SMALL_DU_OFFSETS = (
    (0, -2), (-2, -1), (0, -1), (+2, -1), (-1, 0), (0, 0), (0, 0), (+1, 0),
    (-2, +1), (0, +1), (+2, +1), (0, +2),
)
SMALL_DV_OFFSETS = ((0, -1), (-1, 0), (+1, 0), (0, +1))


def _flat_gather(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, offsets):
    """img[v+dy, u+dx] for each offset -> [N, len(offsets)] (clipped indices)."""
    H, W = img.shape
    dev = img.device
    dx = torch.tensor([o[0] for o in offsets], dtype=torch.int64, device=dev)
    dy = torch.tensor([o[1] for o in offsets], dtype=torch.int64, device=dev)
    u = u.to(torch.int64)
    v = v.to(torch.int64)
    idx = (v[:, None] + dy[None, :]) * W + (u[:, None] + dx[None, :])
    return img.reshape(-1)[idx.clamp(0, H * W - 1)]


def compute_descriptors(du: torch.Tensor, dv: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """32-byte descriptors for features at (u, v). Returns [N, 32] uint8."""
    a = _flat_gather(du, u, v, DESC_OFFSETS)  # [N, 16]
    b = _flat_gather(dv, u, v, DESC_OFFSETS)  # [N, 16]
    return torch.stack([a, b], dim=-1).reshape(a.shape[0], 32)


def compute_small_descriptors(du: torch.Tensor, dv: torch.Tensor,
                              u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """16-byte ELAS descriptors at integer (u, v). Returns [N, 16] uint8."""
    a = _flat_gather(du, u, v, SMALL_DU_OFFSETS)  # [N, 12]
    b = _flat_gather(dv, u, v, SMALL_DV_OFFSETS)  # [N, 4]
    return torch.cat([a, b], dim=-1)
