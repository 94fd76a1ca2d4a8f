"""SECOND 2D BEV backbone and SECONDFPN neck (counterpart of the JAX
package's ``models/second.py``): two conv stages (6 layers each, stride 1
then 2), then the neck upsamples both to a common stride and concatenates.

Maps are NCHW with a batch of one; GroupNorm (16 groups, eps 1e-3) takes
its statistics over the single sample, as torch's does and as the JAX
package's leading batch axis makes flax's do. Padding is explicit (1, 1),
also at stride 2. The stride-2 neck block is a transposed convolution
(kernel = stride); flax's ``ConvTranspose`` taps are spatially mirrored
against torch's ``ConvTranspose2d`` (``convert.py`` flips them).

Module names are the flax ones, the auto-named norms among them
(``GroupNorm_{k}`` in call order).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.routes import relu

GN_GROUPS = 16
GN_EPS = 1e-3
# the W2 config's widths: SECOND's two stages (channels, extra layers,
# stride) and the neck's blocks (channels, upsampling stride)
SECOND_STAGES = ((128, 5, 1), (256, 5, 2))
FPN_BLOCKS = ((256, 1), (256, 2))


def group_norm(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps)


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


class SECOND(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        k = 0
        cin = in_channels
        for i, (c, n, s) in enumerate(SECOND_STAGES):
            for j in range(n + 1):
                self.add_module(f"stage{i}_conv{j}", nn.Conv2d(
                    cin, c, 3, stride=s if j == 0 else 1, padding=1,
                    bias=False))
                self.add_module(f"GroupNorm_{k}", _gn(c))
                k += 1
                cin = c

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [1, C, H, W] BEV map. Returns the stages' maps."""
        outs, k = [], 0
        for i, (_, n, _) in enumerate(SECOND_STAGES):
            for j in range(n + 1):
                x = getattr(self, f"stage{i}_conv{j}")(x)
                x = relu(group_norm(getattr(self, f"GroupNorm_{k}"), x))
                k += 1
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    def __init__(self):
        super().__init__()
        for i, ((cin, _, _), (c, s)) in enumerate(zip(SECOND_STAGES,
                                                     FPN_BLOCKS)):
            # the shipped W2 config's use_conv_for_no_stride: the stride-1
            # block is a 1x1 convolution
            self.add_module(f"deblock{i}", (
                nn.ConvTranspose2d(cin, c, s, stride=s, bias=False) if s > 1
                else nn.Conv2d(cin, c, 1, bias=False)))
            self.add_module(f"GroupNorm_{i}", _gn(c))

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        ups = [relu(group_norm(getattr(self, f"GroupNorm_{i}"),
                                     getattr(self, f"deblock{i}")(x)))
               for i, x in enumerate(feats)]
        return torch.cat(ups, 1)
