"""Train, evaluation and prediction steps.

Port of ``make_train_step`` / ``make_eval_step`` / ``make_predict_step`` and
``_prepare_image`` in ``geo_deep_learning_tpu/training/steps.py``. A uint8
NHWC image goes through the fused normalize kernel (K1) into the compute
dtype; a float image is cast. The model runs NCHW (the NHWC buffer viewed
channels-last), under autocast when the precision is bf16-mixed.

Train step: K1 -> augmentation (NHWC, before the permute) -> forward in
train mode -> main + aux loss -> ``backward`` (K5/K6/K7 inside the
encoder's autograd) -> every ``accumulate`` steps: mean of the summed
gradients, global-norm clip, LR from the schedule, optimizer step. A frozen
encoder's parameters do not require gradients and its input does not
either, so autograd records nothing there and K5-K7 do not launch; BN
statistics still update in train mode. Eval: padded tail samples
(``valid_count``) are masked out of the loss and the confusion matrix.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.ops.augment import AugmentConfig, apply_augmentations
from geo_deep_learning_tpu_torch.ops.cuda.preprocess import fused_normalize_standardize
from geo_deep_learning_tpu_torch.ops.metrics import confusion_matrix, logits_to_preds
from geo_deep_learning_tpu_torch.training.optim import (
    Schedule,
    clip_by_global_norm_,
    set_learning_rate,
)
from geo_deep_learning_tpu_torch.training.task import SegmentationTask


# batch keys that go to the device; names and counts stay on the host
_DEVICE_KEYS = ("image", "mask", "mean", "std", "wavelengths")


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays on ``device``; masks as int64, torch's index type
    (the shard stream's are int32, as in the JAX package)."""
    out = dict(batch)
    for key in _DEVICE_KEYS:
        if key in batch:
            dtype = np.int64 if key == "mask" else None
            out[key] = torch.from_numpy(np.ascontiguousarray(batch[key], dtype=dtype)).to(device)
    return out


def prepare_image(batch: dict, precision: PrecisionPolicy) -> torch.Tensor:
    """NHWC batch image -> NHWC image in the compute dtype."""
    image = batch["image"]
    if image.dtype == torch.uint8:
        return fused_normalize_standardize(
            image, batch["mean"], batch["std"], out_dtype=precision.compute_dtype
        )
    return precision.cast_input(image)


def _forward(task: SegmentationTask, precision: PrecisionPolicy, batch: dict, image):
    image = image.permute(0, 3, 1, 2)
    with precision.autocast(image.device):
        return task.forward(batch, image)


def _sample_weights(batch: dict) -> torch.Tensor | None:
    if "valid_count" not in batch:
        return None
    b = batch["mask"].shape[0]
    return (torch.arange(b, device=batch["mask"].device) < batch["valid_count"]).float()


def make_train_step(
    task: SegmentationTask,
    precision: PrecisionPolicy,
    augment: AugmentConfig | None = AugmentConfig(),
    grad_clip: float | None = 1.0,
    schedule: Schedule | None = None,
    accumulate: int = 1,
) -> Callable[[TrainState, dict], dict]:
    """``(state, batch) -> {"loss"}``; updates ``state`` in place.

    ``schedule`` maps the number of optimizer updates done so far to the
    LR; without it the optimizer's LR stands (the plateau controller, when
    there is one, sets it between epochs).
    """

    def train_step(state: TrainState, batch: dict) -> dict:
        task.model.train()
        image = prepare_image(batch, precision)
        mask = batch["mask"]
        if augment is not None:
            image, mask = apply_augmentations(state.aug_generator, image, mask, augment)
        loss = task.compute_loss(_forward(task, precision, batch, image), mask)
        loss.backward()
        state.step += 1
        if state.step % accumulate == 0:
            params = [p for g in state.optimizer.param_groups for p in g["params"]]
            if accumulate > 1:
                torch._foreach_div_([p.grad for p in params if p.grad is not None], accumulate)
            if grad_clip:
                clip_by_global_norm_(params, grad_clip)
            if schedule is not None:
                set_learning_rate(state.optimizer, schedule(state.step // accumulate - 1))
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach().float()}

    return train_step


def make_eval_step(
    task: SegmentationTask, precision: PrecisionPolicy
) -> Callable[[dict], dict]:
    """``batch -> {"loss", "confusion", "preds"}`` on the batch's device."""

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        task.model.eval()
        out = _forward(task, precision, batch, prepare_image(batch, precision))
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
        task.model.eval()
        out = _forward(task, precision, batch, prepare_image(batch, precision))
        if task.num_classes == 1:
            probs = torch.sigmoid(out.out)
        else:
            probs = torch.softmax(out.out, dim=1)
        return {"probs": probs, "preds": logits_to_preds(out.out, task.threshold)}

    return predict_step
