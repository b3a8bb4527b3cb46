"""DOFA segmentation assembly.

Port of ``geo_deep_learning_tpu/models/segmentation/dofa.py`` (reference
``models/segmentation/dofa.py:24-107``): DOFAv2 encoder -> MultiLevelNeck
(BN+ReLU ConvModules, scales 4, 2, 1, 0.5) -> UperNet decoder (PPM 1, 2,
3, 6; ``align_corners=False``) -> 1x1 head -> bilinear upsample to the
input size; FCN aux head (one conv, 256 channels) on the last neck level.
``remat`` / ``remat_mode`` are the encoder's (a model field only, as in
JAX: the task does not expose them).
Inputs and logits are NCHW; logits come back in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.base import SegmentationOutput
from geo_deep_learning_tpu_torch.models.decoders.upernet import UperNetDecoder
from geo_deep_learning_tpu_torch.models.encoders.dofa import DOFAv2
from geo_deep_learning_tpu_torch.models.heads.fcn import FCNHead
from geo_deep_learning_tpu_torch.models.heads.segmentation import SegmentationHead
from geo_deep_learning_tpu_torch.models.layers import init_torch_default
from geo_deep_learning_tpu_torch.models.necks.multilevel import MultiLevelNeck
from geo_deep_learning_tpu_torch.ops.resize import resize


class DOFASegmentation(nn.Module):
    def __init__(
        self,
        encoder_name: str = "dofa_base",
        num_classes: int = 1,
        decoder_channels: int = 256,
        img_size: int = 512,
        remat: bool = False,
        remat_mode: str = "mlp",
    ) -> None:
        super().__init__()
        self.encoder = DOFAv2(encoder_name, img_size, remat=remat, remat_mode=remat_mode)
        d = self.encoder.embed_dim
        self.neck = MultiLevelNeck([d] * 4, [d] * 4, scales=(4, 2, 1, 0.5))
        self.decoder = UperNetDecoder([d] * 4, decoder_channels, (1, 2, 3, 6), False)
        self.head = SegmentationHead(decoder_channels, num_classes)
        self.aux_head = FCNHead(d, 256, num_convs=1, num_classes=num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        for part in (self.neck, self.decoder, self.head, self.aux_head):
            init_torch_default(part, generator)
        self.encoder.init_weights(generator)

    def forward(
        self, x: torch.Tensor, wavelengths: torch.Tensor | None = None,
        baked_embed: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> SegmentationOutput:
        """``baked_embed``: the encoder's pre-baked patch embedding, in place
        of ``wavelengths`` (``inference/export.py``)."""
        in_hw = x.shape[-2:]
        feats = self.neck(self.encoder(x, wavelengths, baked_embed))
        out = resize(self.head(self.decoder(feats)).float(), size=in_hw)
        aux = resize(self.aux_head(feats[-1]).float(), size=in_hw)
        return SegmentationOutput(out=out, aux=aux)
