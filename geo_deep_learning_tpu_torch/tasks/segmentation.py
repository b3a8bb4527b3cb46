"""Segmentation task specs built from config ``init_args``.

Port of ``SegmentationTaskSpec``, ``SegmentationUnetPlus``,
``SegmentationSegformer`` and ``SegmentationDOFA`` in
``geo_deep_learning_tpu/tasks/segmentation.py`` (reference
``segmentation_unetplus.py:34``, ``segmentation_segformer.py:32``,
``segmentation_dofa.py:33``).
:class:`SegmentationTaskSpec` holds what every family shares: the
:class:`SegmentationTask` (model, loss, class labels, whether the forward
takes wavelengths) and the training wiring that ``Trainer.fit`` consumes
(:meth:`SegmentationTaskSpec.fit_kwargs`): the optimizer and scheduler
dicts, the ``freeze_layers`` patterns, and the initial weights: a
pretrained encoder file (``torch_weights``) and a warm start
(``weights_from_checkpoint_path``, ``load_parts``). Each family builds its
model on the ``meta`` device; the trainer allocates it on the run's device
with weights from a seeded generator, then loads those. A named weight set
(``weights: imagenet``, ``pretrained: true``) is not in the repository:
asking for one logs a warning and keeps the seeded random weights.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Sequence

import torch

from geo_deep_learning_tpu_torch.training.task import SegmentationTask

logger = logging.getLogger(__name__)


class SegmentationTaskSpec:
    """Common plumbing: the task, the optimizer / scheduler dicts, the
    freeze patterns and the initial weights; unknown config keys are
    ignored, as the reference's ``**kwargs`` are."""

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        num_classes: int,
        loss: Callable | None = None,
        uses_wavelengths: bool | None = None,
        class_labels: Sequence[str] | None = None,
        wavelengths: Sequence[float] | None = None,
        optimizer: dict | None = None,
        scheduler: dict | None = None,
        scheduler_config: dict | None = None,
        freeze_layers: Sequence[str] | None = None,
        weights_from_checkpoint_path: str | None = None,
        load_parts: Sequence[str] | str | None = None,
        torch_weights: dict | None = None,
        **extra: Any,
    ) -> None:
        from geo_deep_learning_tpu_torch.ops.losses import DiceLoss

        if extra:
            logger.debug("ignoring task args: %s", list(extra))
        self.task = SegmentationTask(
            model=model,
            loss=loss or DiceLoss(mode="binary" if num_classes == 1 else "multiclass"),
            num_classes=num_classes,
            class_labels=list(class_labels) if class_labels else None,
            default_wavelengths=list(wavelengths) if wavelengths else None,
            uses_wavelengths=uses_wavelengths,
        )
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.scheduler_config = scheduler_config or {"interval": "epoch"}
        self.freeze_layers = list(freeze_layers) if freeze_layers else None
        self.weights_from_checkpoint_path = weights_from_checkpoint_path
        self.load_parts = load_parts
        self.torch_weights = torch_weights

    def weight_kwargs(self) -> dict[str, Any]:
        """The initial weights, as ``Trainer.init_model`` takes them."""
        return {
            "torch_weights": self.torch_weights,
            "weights_from_checkpoint_path": self.weights_from_checkpoint_path,
            "load_parts": self.load_parts,
        }

    def fit_kwargs(self) -> dict[str, Any]:
        return {
            "optimizer": self.optimizer,
            "scheduler": self.scheduler,
            "freeze_layers": self.freeze_layers,
            **self.weight_kwargs(),
        }


def _warn_weights(weights: str | None, encoder: str) -> None:
    if weights is not None:
        logger.warning(
            "%s weights for %s are not in the repository; using seeded random weights",
            weights, encoder,
        )


class SegmentationUnetPlus(SegmentationTaskSpec):
    """UNet++ (ResNet / ResNeXt encoder + nested decoder); the forward takes
    the image alone."""

    def __init__(
        self,
        encoder: str = "resnet34",
        image_size: Sequence[int] = (512, 512),
        in_channels: int = 3,
        num_classes: int = 1,
        weights: str | None = None,
        decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
        **kwargs: Any,
    ) -> None:
        from geo_deep_learning_tpu_torch.models.segmentation.unetpp import UnetPlusPlus

        del image_size  # the model takes any input size divisible by 32
        _warn_weights(weights, encoder)
        with torch.device("meta"):
            model = UnetPlusPlus(
                encoder_name=encoder,
                num_classes=num_classes,
                decoder_channels=tuple(decoder_channels),
                in_channels=in_channels,
            )
        super().__init__(model, num_classes=num_classes, uses_wavelengths=False, **kwargs)


class SegmentationSegformer(SegmentationTaskSpec):
    """SegFormer (MiT or Dynamic encoder + all-MLP decoder); the forward
    takes the image alone."""

    def __init__(
        self,
        encoder: str = "mit_b0",
        image_size: Sequence[int] = (512, 512),
        in_channels: int = 3,
        num_classes: int = 1,
        use_dynamic_encoder: bool = False,
        weights: str | None = None,
        **kwargs: Any,
    ) -> None:
        from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer

        del image_size  # the model takes any input size
        _warn_weights(weights, encoder)
        with torch.device("meta"):
            model = SegFormer(
                encoder_name=encoder,
                num_classes=num_classes,
                use_dynamic_encoder=use_dynamic_encoder,
                in_channels=in_channels,
            )
        super().__init__(model, num_classes=num_classes, uses_wavelengths=False, **kwargs)


class SegmentationDOFA(SegmentationTaskSpec):
    """DOFA + UperNet: main + 0.4 x aux Dice loss, wavelength-conditioned
    forward."""

    def __init__(
        self,
        encoder: str = "dofa_base",
        pretrained: bool = False,
        image_size: Sequence[int] = (512, 512),
        num_classes: int = 1,
        decoder_channels: int = 256,
        **kwargs: Any,
    ) -> None:
        from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation

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
        super().__init__(model, num_classes=num_classes, uses_wavelengths=True, **kwargs)
