"""Evaluation and prediction steps.

Port of ``make_eval_step`` / ``make_predict_step`` and ``_prepare_image``
in ``geo_deep_learning_tpu/training/steps.py``. A uint8 NHWC image goes
through the fused normalize kernel (K1) into the compute dtype; a float
image is cast. The model runs NCHW (the NHWC buffer viewed channels-last),
under autocast when the precision is bf16-mixed. Padded tail samples
(``valid_count``) are masked out of the loss and the confusion matrix.
"""

from __future__ import annotations

from typing import Callable

import torch

from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.ops.cuda.preprocess import fused_normalize_standardize
from geo_deep_learning_tpu_torch.ops.metrics import confusion_matrix, logits_to_preds
from geo_deep_learning_tpu_torch.training.task import SegmentationTask


def prepare_image(batch: dict, precision: PrecisionPolicy) -> torch.Tensor:
    """NHWC batch image -> NHWC image in the compute dtype."""
    image = batch["image"]
    if image.dtype == torch.uint8:
        return fused_normalize_standardize(
            image, batch["mean"], batch["std"], out_dtype=precision.compute_dtype
        )
    return precision.cast_input(image)


def _forward(task: SegmentationTask, precision: PrecisionPolicy, batch: dict):
    image = prepare_image(batch, precision).permute(0, 3, 1, 2)
    with precision.autocast(image.device):
        return task.forward(batch, image)


def _sample_weights(batch: dict) -> torch.Tensor | None:
    if "valid_count" not in batch:
        return None
    b = batch["mask"].shape[0]
    return (torch.arange(b, device=batch["mask"].device) < batch["valid_count"]).float()


def make_eval_step(
    task: SegmentationTask, precision: PrecisionPolicy
) -> Callable[[dict], dict]:
    """``batch -> {"loss", "confusion", "preds"}`` on the batch's device."""

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        out = _forward(task, precision, batch)
        weights = _sample_weights(batch)
        loss = task.compute_loss(out, batch["mask"], sample_weights=weights)
        preds = logits_to_preds(out.out, task.threshold)
        cm = confusion_matrix(preds, batch["mask"], task.eval_classes, sample_weights=weights)
        return {"loss": loss.float(), "confusion": cm, "preds": preds}

    return eval_step


def make_predict_step(
    task: SegmentationTask, precision: PrecisionPolicy
) -> Callable[[dict], dict]:
    """``batch -> {"probs" [B, C, H, W], "preds" [B, H, W]}``."""

    @torch.inference_mode()
    def predict_step(batch: dict) -> dict:
        out = _forward(task, precision, batch)
        if task.num_classes == 1:
            probs = torch.sigmoid(out.out)
        else:
            probs = torch.softmax(out.out, dim=1)
        return {"probs": probs, "preds": logits_to_preds(out.out, task.threshold)}

    return predict_step
