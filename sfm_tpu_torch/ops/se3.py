"""SE(3) helpers matching the reference's Euler convention.

transformationVectorToMatrix (viso.cpp:59-84): Tr = [R(rx,ry,rz) | t] with the
exact element layout the reference uses (written out literally);
rotation_angles inverts it (viso_mono.cpp:176-178).
"""

from __future__ import annotations

import torch


def transformation_vector_to_matrix(tr: torch.Tensor) -> torch.Tensor:
    """tr = [rx, ry, rz, tx, ty, tz] -> 4x4 homogeneous matrix (viso.cpp:59-84)."""
    rx, ry, rz, tx, ty, tz = tr[0], tr[1], tr[2], tr[3], tr[4], tr[5]
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    row0 = torch.stack([cy * cz, -cy * sz, sy, tx])
    row1 = torch.stack([sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy, ty])
    row2 = torch.stack([-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz, cx * cy, tz])
    row3 = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tr.dtype, device=tr.device)
    return torch.stack([row0, row1, row2, row3])


def rotation_angles(R: torch.Tensor):
    """Recover (rx, ry, rz) from the rotation above (viso_mono.cpp:176-178)."""
    ry = torch.arcsin(R[0, 2].clamp(-1.0, 1.0))
    cy = torch.cos(ry)
    rx = torch.arcsin((-R[1, 2] / cy).clamp(-1.0, 1.0))
    rz = torch.arcsin((-R[0, 1] / cy).clamp(-1.0, 1.0))
    return rx, ry, rz


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse (replaces Matrix::inv in sfm.hh:57)."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti
