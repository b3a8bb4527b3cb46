"""Segmentation task spec built from config ``init_args``.

Port of ``SegmentationTaskSpec`` / ``SegmentationDOFA`` in
``geo_deep_learning_tpu/tasks/segmentation.py`` (reference
``segmentation_dofa.py:33``): DOFA + UperNet with main + 0.4 x aux Dice
loss and a wavelength-conditioned forward, plus the training wiring that
``Trainer.fit`` consumes (:meth:`SegmentationDOFA.fit_kwargs`): the
optimizer and scheduler dicts and the ``freeze_layers`` patterns. The model
is built on the ``meta`` device; ``task.materialize`` allocates it on the
run's device with weights from a seeded generator. Pretrained weights and
warm starts from a checkpoint are not ported: setting them raises.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Sequence

import torch

from geo_deep_learning_tpu_torch.training.task import SegmentationTask

logger = logging.getLogger(__name__)

_NOT_PORTED = ("weights_from_checkpoint_path", "load_parts", "torch_weights")


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
        optimizer: dict | None = None,
        scheduler: dict | None = None,
        scheduler_config: dict | None = None,
        freeze_layers: Sequence[str] | None = None,
        **extra: Any,
    ) -> None:
        from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
        from geo_deep_learning_tpu_torch.ops.losses import DiceLoss

        for key in _NOT_PORTED:
            if extra.pop(key, None):
                msg = f"{key} is not ported yet; the port trains from seeded random weights"
                raise NotImplementedError(msg)
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
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.scheduler_config = scheduler_config or {"interval": "epoch"}
        self.freeze_layers = list(freeze_layers) if freeze_layers else None

    def fit_kwargs(self) -> dict[str, Any]:
        return {
            "optimizer": self.optimizer,
            "scheduler": self.scheduler,
            "freeze_layers": self.freeze_layers,
        }
