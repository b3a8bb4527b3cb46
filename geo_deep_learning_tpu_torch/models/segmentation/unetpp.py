"""UNet++ assembly: ResNet encoder -> nested decoder -> 3x3 head.

Port of ``geo_deep_learning_tpu/models/segmentation/unetpp.py`` (reference
capability: ``smp.UnetPlusPlus(encoder_name, in_channels, encoder_weights,
classes)``). The head is smp's ``SegmentationHead``: a 3x3 conv with bias
on the full-resolution decoder output (``segmentation_head.0``), which is
what the JAX package's packed tail computes in its own layout. Inputs and
logits are NCHW; logits come back in f32 at the input size, with no
auxiliary head. Built on any device (``meta`` included), then
:meth:`init_weights` draws every tensor from a seeded generator.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.base import SegmentationOutput
from geo_deep_learning_tpu_torch.models.decoders.unetpp import UnetPlusPlusDecoder
from geo_deep_learning_tpu_torch.models.encoders.resnet import ResNetEncoder
from geo_deep_learning_tpu_torch.models.layers import init_torch_default


class UnetPlusPlus(nn.Module):
    def __init__(
        self,
        encoder_name: str = "resnet34",
        num_classes: int = 1,
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        in_channels: int = 3,
    ) -> None:
        super().__init__()
        self.encoder = ResNetEncoder(encoder_name, in_channels)
        self.decoder = UnetPlusPlusDecoder(self.encoder.out_channels, decoder_channels)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], num_classes, 3, padding=1)
        )

    def init_weights(self, generator: torch.Generator) -> None:
        init_torch_default(self, generator)

    def forward(self, x: torch.Tensor) -> SegmentationOutput:
        logits = self.segmentation_head(self.decoder(self.encoder(x)))
        return SegmentationOutput(out=logits.float(), aux=None)
