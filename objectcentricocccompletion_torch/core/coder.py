"""Delta-XYZWLHR box coder (counterpart of the JAX package's
``core/coder.py::encode/decode``). Boxes are ``[..., 7]``
(x, y, z_bottom, w, l, h, yaw)."""
from __future__ import annotations

import torch

CODE_SIZE = 7


def encode(anchors: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Deltas taking ``anchors`` to ``targets``; boxes are bottom-centre."""
    xa, ya, za, wa, la, ha, ra = anchors.split(1, -1)
    xg, yg, zg, wg, lg, hg, rg = targets.split(1, -1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    return torch.cat([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                      torch.log(wg / wa), torch.log(lg / la),
                      torch.log(hg / ha), rg - ra], -1)


def decode(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    xa, ya, za, wa, la, ha, ra = anchors.split(1, -1)
    xt, yt, zt, wt, lt, ht, rt = deltas.split(1, -1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    return torch.cat([xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
                      torch.exp(wt) * wa, torch.exp(lt) * la, hg, rt + ra],
                     -1)
