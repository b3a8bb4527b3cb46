"""Multi-level neck: ViT taps -> FPN-style pyramid.

Port of ``geo_deep_learning_tpu/models/necks/multilevel.py`` with the
wiring the DOFA assembly uses (``use_norm_act=True``): per level a 1x1
ConvModule (conv bias kept, BN, ReLU), a bilinear rescale by
``scales[i]``, and a 3x3 ConvModule. The JAX package runs the integer
up-scales as an exact factored resize+conv (``ops/fused_upconv.py``); the
port runs the plain resize then conv, equal up to summation order.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import ConvModule
from geo_deep_learning_tpu_torch.ops.resize import resize


class MultiLevelNeck(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: Sequence[int],
        scales: Sequence[float] = (0.5, 1, 2, 4),
    ) -> None:
        super().__init__()
        self.scales = tuple(scales)
        self.lateral_convs = nn.ModuleList(
            ConvModule(ci, co, 1, bias=True) for ci, co in zip(in_channels, out_channels)
        )
        self.convs = nn.ModuleList(ConvModule(co, co, 3, bias=True) for co in out_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for x, lateral, conv, scale in zip(inputs, self.lateral_convs, self.convs, self.scales):
            x = lateral(x)
            if scale != 1:
                x = resize(x, scale_factor=scale)
            outs.append(conv(x))
        return outs
