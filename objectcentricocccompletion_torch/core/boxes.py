"""3D box geometry (counterpart of the JAX package's ``core/boxes.py``,
the parts the OcOccNet forward uses).

Boxes are ``[..., 7]``: bottom centre (x, y, z), sizes (w, l, h) along
(x, y, z), yaw about z. The box-local frame is
``rotate_z(p - gravity_center, -yaw)``, so ``local_x`` spans ``w`` and a
point is inside iff ``|local| <= size / 2`` componentwise.
"""
from __future__ import annotations

import torch


def rotate_z(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate ``points[..., 3]`` by ``angles[...]`` about z:
    out_x = x cos + y sin, out_y = -x sin + y cos."""
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    ox = x * c + y * s
    oy = -x * s + y * c
    return torch.cat([ox, oy, z.expand(ox.shape)], -1)


def gravity_center(boxes: torch.Tensor) -> torch.Tensor:
    """Bottom-centre boxes -> volumetric centres, ``[..., 3]``."""
    z = boxes[..., 2:3] + 0.5 * boxes[..., 5:6]
    return torch.cat([boxes[..., 0:2], z], -1)


def box_local_coords(points: torch.Tensor, boxes: torch.Tensor
                     ) -> torch.Tensor:
    """``points[..., P, 3]`` in the local frame of ``boxes[..., 7]``."""
    ctr = gravity_center(boxes)
    return rotate_z(points - ctr[..., None, :], -boxes[..., None, 6])


def local_to_global(local: torch.Tensor, boxes: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of :func:`box_local_coords`."""
    ctr = gravity_center(boxes)
    return rotate_z(local, boxes[..., None, 6]) + ctr[..., None, :]
