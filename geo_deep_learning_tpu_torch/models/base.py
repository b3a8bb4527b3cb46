"""Output contract shared by the segmentation assemblies.

Port of ``geo_deep_learning_tpu/models/base.py``. Logits are NCHW.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentationOutput(NamedTuple):
    out: torch.Tensor  # [B, num_classes, H, W] logits at input resolution
    aux: torch.Tensor | None = None  # auxiliary-head logits or None
