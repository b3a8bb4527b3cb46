"""SegFormer assembly: MiT encoder -> all-MLP decoder -> upsample to input.

Port of ``geo_deep_learning_tpu/models/segmentation/segformer.py``
(reference ``SegFormerSegmentationModel``): the encoder is a standard MiT
(b0-b5) or, with ``use_dynamic_encoder``, the channel-agnostic
``DynamicMixTransformer``; the decoder's embedding dim is 256 for b0/b1
and 768 for larger variants. Inputs and logits are NCHW; logits come back
in f32 at the input size, with no auxiliary head. Built on any device
(``meta`` included), then :meth:`init_weights` draws every tensor from a
seeded generator.
"""

from __future__ import annotations

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.base import SegmentationOutput
from geo_deep_learning_tpu_torch.models.decoders.segformer_mlp import SegFormerMLPDecoder
from geo_deep_learning_tpu_torch.models.encoders.mix_transformer import (
    DynamicMixTransformer,
    MixVisionTransformer,
)
from geo_deep_learning_tpu_torch.models.layers import init_torch_default
from geo_deep_learning_tpu_torch.ops.resize import resize


class SegFormer(nn.Module):
    def __init__(
        self,
        encoder_name: str = "mit_b0",
        num_classes: int = 1,
        use_dynamic_encoder: bool = False,
        dropout_ratio: float = 0.1,
        in_channels: int = 3,
    ) -> None:
        super().__init__()
        if use_dynamic_encoder:
            self.encoder = DynamicMixTransformer(encoder_name)
        else:
            self.encoder = MixVisionTransformer(encoder_name, in_channels)
        embedding_dim = 256 if encoder_name in ("mit_b0", "mit_b1") else 768
        self.decoder = SegFormerMLPDecoder(
            self.encoder.out_channels, num_classes, embedding_dim, dropout_ratio
        )

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        init_torch_default(self.decoder, generator)

    def forward(self, x: torch.Tensor) -> SegmentationOutput:
        logits = self.decoder(self.encoder(x))
        return SegmentationOutput(out=resize(logits.float(), size=x.shape[-2:]), aux=None)
