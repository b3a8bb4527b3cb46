"""Deployment model wrappers over :mod:`geo_deep_learning_tpu_torch.inference.export`.

Port of ``geo_deep_learning_tpu/tools/script_model.py`` (reference
``tools/script_model.py:10-86``, ``ScriptModel`` /
``SegmentationScriptModel``: the eval model with normalization and
softmax / sigmoid folded in). The artifact is a saved ``torch.export``
program (``.pt2``); these classes keep the reference's object-style
surface on top of it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from geo_deep_learning_tpu_torch.inference.export import (
    export_model,
    load_exported,
    make_serving_fn,
)


class ScriptModel:
    """Callable serving model: raw 0-255 imagery ``[B, H, W, C]`` -> class
    probabilities ``[B, H, W, classes]``."""

    def __init__(
        self,
        model: nn.Module,
        input_shape: tuple[int, ...],
        mean: Sequence[float],
        std: Sequence[float],
        num_classes: int,
        wavelengths: Sequence[float] | None = None,
        precision: str = "bf16-mixed",
    ) -> None:
        self.input_shape = tuple(input_shape)
        self.serving_fn = make_serving_fn(model, mean=mean, std=std, num_classes=num_classes,
                                          wavelengths=wavelengths, precision=precision)

    def __call__(self, image) -> torch.Tensor:
        """A numpy array or tensor ``[B, H, W, C]`` -> probabilities on the
        model's device."""
        device = self.serving_fn.mean.device
        with torch.inference_mode():
            return self.serving_fn(torch.as_tensor(image, dtype=torch.float32).to(device))

    def save(self, path: str, batch_polymorphic: bool = True, device: str = "cuda") -> str:
        """Export and save the program (``.pt2``) on ``device``."""
        return str(export_model(self.serving_fn, self.input_shape, path,
                                batch_polymorphic=batch_polymorphic, device=device))

    @staticmethod
    def load(path: str, device: str = "cuda"):
        return load_exported(path, device=device)


class SegmentationScriptModel(ScriptModel):
    """Alias kept for reference naming (the serving module takes the
    ``SegmentationOutput``'s main logits)."""
