"""Segmentation task: binds a model assembly, a loss and batch semantics.

Port of ``geo_deep_learning_tpu/training/task.py``: the model's
allocation with seeded weights (:meth:`SegmentationTask.materialize`), the
forward (with wavelengths, as DOFA takes them, defaulting to the task's
own when the batch has none), main + ``aux_loss_weight`` x aux loss, and
the binary quirk of evaluating a one-class task over two classes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn


@dataclass
class SegmentationTask:
    model: nn.Module
    loss: Callable
    num_classes: int = 1
    aux_loss_weight: float = 0.4  # applied only when the model emits aux
    threshold: float = 0.5
    class_labels: Sequence[str] | None = None
    default_wavelengths: Sequence[float] | None = None

    @property
    def eval_classes(self) -> int:
        """Binary tasks evaluate {background, foreground} (reference quirk)."""
        return 2 if self.num_classes == 1 else self.num_classes

    def materialize(self, device: torch.device, seed: int) -> nn.Module:
        """Allocate the model on ``device`` (it may be built on the ``meta``
        device) with weights drawn from a generator seeded with ``seed``, in
        eval mode, channels-last on CUDA (where cuDNN wants it)."""
        model = self.model.to_empty(device=device)
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model.eval()
        return self.model

    def model_args(self, batch: dict, image: torch.Tensor) -> tuple:
        wv = batch.get("wavelengths")
        if wv is None:
            if self.default_wavelengths is None:
                msg = "batch has no wavelengths and the task sets no default"
                raise ValueError(msg)
            wv = self.default_wavelengths
        return (image, torch.as_tensor(wv, dtype=torch.float32, device=image.device))

    def forward(self, batch: dict, image: torch.Tensor):
        return self.model(*self.model_args(batch, image))

    def compute_loss(self, output, mask, sample_weights=None) -> torch.Tensor:
        loss = self.loss(output.out, mask, sample_weights=sample_weights)
        if output.aux is not None:
            loss = loss + self.aux_loss_weight * self.loss(
                output.aux, mask, sample_weights=sample_weights
            )
        return loss
