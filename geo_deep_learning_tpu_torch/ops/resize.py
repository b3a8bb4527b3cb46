"""Bilinear resize of NCHW tensors.

Port of the bilinear path of ``geo_deep_learning_tpu/ops/resize.py``:
``align_corners=False`` is half-pixel sampling with edge clamping and
``align_corners=True`` corner-aligned sampling, both without antialiasing
(torch ``F.interpolate`` semantics, which the JAX package reproduces).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize(
    x: torch.Tensor,
    size: tuple[int, int] | None = None,
    scale_factor: float | None = None,
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize ``[B, C, H, W]`` to ``size`` or by ``scale_factor``."""
    if (size is None) == (scale_factor is None):
        msg = "exactly one of size / scale_factor required"
        raise ValueError(msg)
    h, w = x.shape[-2:]
    if size is None:
        size = (int(h * scale_factor), int(w * scale_factor))
    size = (int(size[0]), int(size[1]))
    if size == (h, w):
        return x
    return F.interpolate(
        x, size=size, mode="bilinear", align_corners=align_corners, antialias=False
    )
