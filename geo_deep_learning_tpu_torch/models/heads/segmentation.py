"""1x1 convolution segmentation head (reference ``segmentation_head.py:16-26``)."""

from __future__ import annotations

import torch
from torch import nn


class SegmentationHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
