"""FCN auxiliary head.

Port of ``geo_deep_learning_tpu/models/heads/fcn.py`` (reference
``fcn_head.py``): ``num_convs`` x (3x3 conv + BN + ReLU) -> element-wise
dropout (flax ``nn.Dropout`` as the JAX package has it, not torch's
channel-wise ``Dropout2d``; identity in eval) -> 1x1 classifier.
"""

from __future__ import annotations

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import ConvModule, Dropout


class FCNHead(nn.Module):
    def __init__(
        self,
        in_channels: int,
        channels: int = 256,
        num_convs: int = 2,
        num_classes: int = 19,
        dropout_ratio: float = 0.1,
    ) -> None:
        super().__init__()
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else channels, channels, 3)
            for i in range(num_convs)
        )
        self.dropout = Dropout(dropout_ratio)
        self.cls_seg = nn.Conv2d(channels if num_convs else in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return self.cls_seg(self.dropout(x))
