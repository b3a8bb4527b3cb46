"""SegFormer all-MLP decoder.

Port of ``geo_deep_learning_tpu/models/decoders/segformer_mlp.py``
(reference ``models/decoders/segformer_mlp.py``): each of the four encoder
features is projected to ``embedding_dim`` by a Linear over its channels,
resized bilinearly to the finest (1/4) level, and the four are
concatenated in [c4, c3, c2, c1] order; then a bias-free 1x1 conv,
BatchNorm (flax statistics, eps 1e-5), ReLU, element-wise dropout and the
1x1 classifier. Features and logits are NCHW; parameter names are the
reference's (``linear_c{i}.proj``, ``linear_fuse.{0,1}``, ``linear_pred``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import BatchNorm2d, Dropout
from geo_deep_learning_tpu_torch.ops.resize import resize


class MLP(nn.Module):
    """A Linear over the channels of an NCHW map."""

    def __init__(self, in_dim: int, out_dim: int) -> None:
        super().__init__()
        self.proj = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SegFormerMLPDecoder(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        num_classes: int,
        embedding_dim: int = 256,
        dropout_ratio: float = 0.1,
    ) -> None:
        super().__init__()
        for i, c in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{i}", MLP(c, embedding_dim))
        self.linear_fuse = nn.Sequential(
            nn.Conv2d(4 * embedding_dim, embedding_dim, 1, bias=False),
            BatchNorm2d(embedding_dim, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
        )
        self.dropout = Dropout(dropout_ratio)
        self.linear_pred = nn.Conv2d(embedding_dim, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        size = feats[0].shape[-2:]
        projected = [
            resize(getattr(self, f"linear_c{i}")(feats[i - 1]), size=size)
            for i in (4, 3, 2, 1)
        ]
        x = self.linear_fuse(torch.cat(projected, dim=1))
        return self.linear_pred(self.dropout(x))
