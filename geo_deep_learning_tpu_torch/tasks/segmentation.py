"""Segmentation task spec built from config ``init_args``.

Port of ``SegmentationDOFA`` in ``geo_deep_learning_tpu/tasks/segmentation.py``
(reference ``segmentation_dofa.py:33``): DOFA + UperNet with main + 0.4 x
aux Dice loss and a wavelength-conditioned forward. The model is built on
the ``meta`` device; :meth:`SegmentationDOFA.materialize` allocates it on
the run's device and draws its weights from a seeded generator. Checkpoint
restore and pretrained weights wait for the training slice.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Sequence

import torch

from geo_deep_learning_tpu_torch.training.task import SegmentationTask

logger = logging.getLogger(__name__)


class SegmentationDOFA:
    def __init__(
        self,
        encoder: str = "dofa_base",
        pretrained: bool = False,
        image_size: Sequence[int] = (512, 512),
        num_classes: int = 1,
        loss: Callable | None = None,
        decoder_channels: int = 256,
        class_labels: Sequence[str] | None = None,
        wavelengths: Sequence[float] | None = None,
        **extra: Any,
    ) -> None:
        from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
        from geo_deep_learning_tpu_torch.ops.losses import DiceLoss

        if extra:
            logger.debug("ignoring task args: %s", list(extra))
        if pretrained:
            logger.warning(
                "pretrained DOFA weights are not in the repository; using seeded random weights"
            )
        if image_size[0] != image_size[1]:
            msg = f"DOFA takes square inputs, got image_size {image_size}"
            raise ValueError(msg)
        with torch.device("meta"):
            model = DOFASegmentation(
                encoder_name=encoder,
                num_classes=num_classes,
                decoder_channels=decoder_channels,
                img_size=int(image_size[0]),
            )
        self.task = SegmentationTask(
            model=model,
            loss=loss or DiceLoss(mode="binary" if num_classes == 1 else "multiclass"),
            num_classes=num_classes,
            aux_loss_weight=0.4,
            class_labels=list(class_labels) if class_labels else None,
            default_wavelengths=list(wavelengths) if wavelengths else None,
        )

    def materialize(self, device: torch.device, seed: int) -> torch.nn.Module:
        """Allocate the model on ``device`` with seeded random weights, in
        eval mode (channels-last memory on CUDA, where cuDNN wants it)."""
        model = self.task.model.to_empty(device=device)
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.task.model = model.eval()
        return self.task.model
