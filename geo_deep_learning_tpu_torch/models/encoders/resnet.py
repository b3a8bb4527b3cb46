"""ResNet / ResNeXt encoders (NCHW) for UNet++.

Port of ``geo_deep_learning_tpu/models/encoders/resnet.py``: the
torchvision topology, returning a 5-level pyramid at strides 2, 4, 8, 16
and 32 (the stem's ReLU output, then each stage), which UNet++'s nested
decoder consumes. Parameter names are torchvision's (``conv1``, ``bn1``,
``layerN.M.{conv,bn}{1,2,3}``, ``layerN.M.downsample.{0,1}``), the names
``convert_resnet`` of the JAX package reads. Convs carry no bias and pad
symmetrically (``(1, 1)`` on the stride-2 3x3 convs too); the stem's max
pool pads with -inf; BatchNorms keep flax statistics (momentum 0.9, biased
variance, eps 1e-5).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import BatchNorm2d


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential | None:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = _bn(features)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, features, stride)
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 - 3x3 (grouped) - 1x1 residual block (ResNet-50+ / ResNeXt)."""

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 1,
                 expansion: int = 4) -> None:
        super().__init__()
        out = features * expansion
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, stride, groups)
        self.bn2 = _bn(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = _bn(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, out, stride)
        self.out_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


@dataclass(frozen=True)
class ResNetConfig:
    block: str  # "basic" | "bottleneck"
    layers: tuple[int, int, int, int]
    groups: int = 1
    width_per_group: int = 64


resnet_configs: dict[str, ResNetConfig] = {
    "resnet18": ResNetConfig("basic", (2, 2, 2, 2)),
    "resnet34": ResNetConfig("basic", (3, 4, 6, 3)),
    "resnet50": ResNetConfig("bottleneck", (3, 4, 6, 3)),
    "resnet101": ResNetConfig("bottleneck", (3, 4, 23, 3)),
    "resnet152": ResNetConfig("bottleneck", (3, 8, 36, 3)),
    "resnext50_32x4d": ResNetConfig("bottleneck", (3, 4, 6, 3), groups=32, width_per_group=4),
    "resnext101_32x8d": ResNetConfig("bottleneck", (3, 4, 23, 3), groups=32, width_per_group=8),
}


class ResNetEncoder(nn.Module):
    """torchvision-topology ResNet returning ``[c1, c2, c3, c4, c5]``."""

    def __init__(self, variant: str = "resnet34", in_channels: int = 3) -> None:
        super().__init__()
        cfg = resnet_configs[variant]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)  # pads with -inf
        cin = 64
        for stage, (blocks, width) in enumerate(zip(cfg.layers, (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                if cfg.block == "basic":
                    block = BasicBlock(cin, width, stride)
                else:
                    bw = width * cfg.width_per_group * cfg.groups // 64
                    block = Bottleneck(cin, bw, stride, cfg.groups, (width * 4) // bw)
                layer.append(block)
                cin = block.out_channels
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.out_channels = (64, 64, 128, 256, 512) if cfg.block == "basic" else (
            64, 256, 512, 1024, 2048)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        feats = [x]  # stride 2
        x = self.maxpool(x)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            feats.append(x)
        return feats
