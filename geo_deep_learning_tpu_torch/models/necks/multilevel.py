"""Multi-level neck: ViT taps -> FPN-style pyramid.

Port of ``geo_deep_learning_tpu/models/necks/multilevel.py`` with the
wiring the DOFA assembly uses (``use_norm_act=True``): per level a 1x1
ConvModule (conv bias kept, BN, ReLU), a bilinear rescale by
``scales[i]``, and a 3x3 ConvModule. With ``fuse_scale4`` (on by default,
as in the JAX package) the integer up-scales 2 and 4 run their resize and
3x3 conv as the exact factored form (``ops/fused_upconv.py``) through the
ConvModule's own conv weight and bias, then its BN and ReLU, so the
``state_dict`` is the same either way; scales 1 and 0.5 resize, then conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import ConvModule
from geo_deep_learning_tpu_torch.ops.fused_upconv import resize_conv3x3_factored
from geo_deep_learning_tpu_torch.ops.resize import resize


class MultiLevelNeck(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: Sequence[int],
        scales: Sequence[float] = (0.5, 1, 2, 4),
        fuse_scale4: bool = True,
    ) -> None:
        super().__init__()
        self.scales = tuple(scales)
        self.fuse_scale4 = fuse_scale4
        self.lateral_convs = nn.ModuleList(
            ConvModule(ci, co, 1, bias=True) for ci, co in zip(in_channels, out_channels)
        )
        self.convs = nn.ModuleList(ConvModule(co, co, 3, bias=True) for co in out_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for x, lateral, conv, scale in zip(inputs, self.lateral_convs, self.convs, self.scales):
            x = lateral(x)
            if scale in (2, 4) and self.fuse_scale4:
                size = (int(scale) * x.shape[-2], int(scale) * x.shape[-1])
                y = resize_conv3x3_factored(x, conv.conv.weight, conv.conv.bias, size)
                outs.append(conv.act(conv.norm(y)))
                continue
            if scale != 1:
                x = resize(x, scale_factor=scale)
            outs.append(conv(x))
        return outs
