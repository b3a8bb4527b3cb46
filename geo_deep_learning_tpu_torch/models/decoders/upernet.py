"""UperNet decoder: PPM over the deepest level + FPN top-down fusion.

Port of ``geo_deep_learning_tpu/models/decoders/upernet.py`` (reference
``decoders/upernet.py``, mmseg-derived): PPM (pools 1, 2, 3, 6) and a 3x3
bottleneck on the last level; 1x1 laterals on the others; top-down adds
with bilinear upsampling; 3x3 FPN convs; everything upsampled to the
finest level, concatenated and fused by a 3x3 ConvModule. With
``fuse_bottleneck`` (on by default, as in the JAX package's
``_FusedBottleneck``) that last resize + concat + conv runs as a sum of
per-part convs over slices of ``fpn_bottleneck``'s weight along its input
channels: a plain 3x3 conv for the part already at the target size, the
exact factored form (``ops/fused_upconv.py``) for every other part; the sum
then goes through the ConvModule's BN and ReLU. Module tree and names do
not change.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import PPM, ConvModule
from geo_deep_learning_tpu_torch.ops.fused_upconv import resize_conv3x3_factored
from geo_deep_learning_tpu_torch.ops.resize import resize


class UperNetDecoder(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        channels: int = 256,
        pool_scales: Sequence[int] = (1, 2, 3, 6),
        align_corners: bool = False,
        fuse_bottleneck: bool = True,
    ) -> None:
        super().__init__()
        self.align_corners = align_corners
        self.fuse_bottleneck = fuse_bottleneck
        top = in_channels[-1]
        self.psp_modules = PPM(pool_scales, top, channels, align_corners)
        self.bottleneck = ConvModule(top + len(pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(ConvModule(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, 3) for _ in in_channels[:-1]
        )
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels, channels, 3)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs[:-1])]
        top = inputs[-1]
        laterals.append(self.bottleneck(torch.cat([top, *self.psp_modules(top)], dim=1)))
        n = len(laterals)
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], size=laterals[i - 1].shape[-2:], align_corners=self.align_corners
            )
        outs = [conv(laterals[i]) for i, conv in enumerate(self.fpn_convs)] + [laterals[-1]]
        target = outs[0].shape[-2:]
        if self.fuse_bottleneck:
            return self._fused_bottleneck(outs, tuple(target))
        outs = [outs[0]] + [
            resize(o, size=target, align_corners=self.align_corners) for o in outs[1:]
        ]
        return self.fpn_bottleneck(torch.cat(outs, dim=1))

    def _fused_bottleneck(self, parts: list[torch.Tensor], target: tuple[int, int]) -> torch.Tensor:
        """``fpn_bottleneck(cat(parts resized to target))`` as a sum of
        per-part 3x3 convs (JAX package ``upernet.py:43-103``)."""
        module = self.fpn_bottleneck
        total = None
        off = 0
        for p in parts:
            w = module.conv.weight[:, off : off + p.shape[1]]
            off += p.shape[1]
            if tuple(p.shape[-2:]) == target:
                y = F.conv2d(p, w, padding=1)
            else:
                y = resize_conv3x3_factored(p, w, None, target, self.align_corners)
            total = y if total is None else total + y
        return module.act(module.norm(total))
