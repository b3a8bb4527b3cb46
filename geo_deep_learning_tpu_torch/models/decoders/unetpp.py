"""UNet++ decoder: dense nested skip pathways with smp's channel scheme.

Port of ``geo_deep_learning_tpu/models/decoders/unetpp.py`` (Zhou et al.,
"UNet++: Redesigning Skip Connections to Exploit Multiscale Features in
Image Segmentation"), in the plain form of ``segmentation_models_pytorch``:

- encoder features are taken deepest first; node ``x_{d}_{j}`` sits at the
  resolution of reversed feature ``j + 1`` and computes
  ``Block(up2(x_{d}_{j-1}), concat(x_{d+1..j}_{j}, feats[j+1]))`` (first
  column: ``Block(up2(feats[d]), feats[d+1])``), where ``Block`` is nearest
  x2 upsampling, concatenation of the skips, then two 3x3 conv + BatchNorm
  + ReLU modules;
- only the backbone column ``x_0_j`` has ``decoder_channels[j]`` channels;
  every dense node (d > 0) keeps its level's encoder width;
- a final skip-free block ``x_0_{depth}`` upsamples to the input's
  resolution.

Module names are smp's (``blocks.x_{d}_{j}.conv{1,2}.{0,1}``). The JAX
package's TPU execution forms of the same parameters (packed tail and
column, factored up2, merged skips, the W-packed column) compute the same
function and are not ported, nor is its ``deep_supervision`` output, which
no model uses.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import BatchNorm2d


class Conv2dReLU(nn.Sequential):
    """3x3 conv (no bias) + BatchNorm (flax statistics, eps 1e-5) + ReLU."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__(
            nn.Conv2d(cin, cout, 3, padding=1, bias=False),
            BatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
        )


class DecoderBlock(nn.Module):
    """Upsample x2 (nearest) -> concat skips -> two :class:`Conv2dReLU`."""

    def __init__(self, in_channels: int, features: int) -> None:
        super().__init__()
        self.conv1 = Conv2dReLU(in_channels, features)
        self.conv2 = Conv2dReLU(features, features)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        if skips:
            x = torch.cat([x, *skips], dim=1)
        return self.conv2(self.conv1(x))


class UnetPlusPlusDecoder(nn.Module):
    """Dense nested decoder over an encoder pyramid (smp wiring).

    Args:
        encoder_channels: the pyramid's widths, finest first (ResNet-18/34:
            ``(64, 64, 128, 256, 512)``).
        decoder_channels: backbone-column widths, deepest node first; the
            last entry is the full-resolution output width.
    """

    def __init__(
        self,
        encoder_channels: Sequence[int],
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
    ) -> None:
        super().__init__()
        feat_ch = list(encoder_channels)[::-1]  # deepest first
        depth = len(feat_ch) - 1
        if len(decoder_channels) != depth + 1:
            msg = (f"need {depth + 1} decoder channels for {len(feat_ch)} encoder features, "
                   f"got {len(decoder_channels)}")
            raise ValueError(msg)
        out_ch = list(decoder_channels)
        skip_ch = feat_ch[1:]
        self.depth = depth
        self.blocks = nn.ModuleDict()
        node_ch: dict[tuple[int, int], int] = {}
        for layer in range(depth):
            for d in range(depth - layer):
                j = d + layer
                node_ch[(d, j)] = out_ch[j] if d == 0 else skip_ch[j]
                up = feat_ch[d] if layer == 0 else node_ch[(d, j - 1)]
                cin = up + sum(node_ch[(i, j)] for i in range(d + 1, j + 1)) + feat_ch[j + 1]
                self.blocks[f"x_{d}_{j}"] = DecoderBlock(cin, node_ch[(d, j)])
        self.blocks[f"x_0_{depth}"] = DecoderBlock(node_ch[(0, depth - 1)], out_ch[depth])

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = list(features)[::-1]
        depth = self.depth
        dense: dict[tuple[int, int], torch.Tensor] = {}
        for layer in range(depth):
            for d in range(depth - layer):
                j = d + layer
                x = feats[d] if layer == 0 else dense[(d, j - 1)]
                skips = [dense[(i, j)] for i in range(d + 1, j + 1)] + [feats[j + 1]]
                dense[(d, j)] = self.blocks[f"x_{d}_{j}"](x, skips)
        return self.blocks[f"x_0_{depth}"](dense[(0, depth - 1)])
