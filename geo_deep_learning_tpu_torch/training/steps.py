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

Data parallelism (``mesh`` with a process group): a batch that is this
rank's block of a global batch (``core.mesh.shard_batch``) runs inside
``parallel.collectives.batch_context``, so its loss and train-mode
BatchNorm statistics are the global batch's. The train step drives the
model through ``DistributedDataParallel`` (``broadcast_buffers=False``:
the BatchNorm statistics are equal on every rank by construction; the
parameters are replicated by the trainer, so no sync at wrap time), with
``no_sync`` on every micro-step of an accumulation but the last; the
gradient mean, clip and update then see the all-reduced gradients. Frozen
parameters do not require gradients and so stay out of DDP's buckets.

Tensor parallelism (a mesh with a model axis): the model holds this rank's
shards (``parallel.placement.place_state``) and its blocks sum over the
model group themselves; DDP runs over the data group; the replicated
parameters' gradients are averaged over the model group before the
update (``average_over_model_``: the card's atomic sums can leave the
ranks' copies a few ulps apart), and the clip's global norm sums the
sharded gradients' squares over the model group.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from geo_deep_learning_tpu_torch.core.mesh import Mesh
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.ops.augment import AugmentConfig, apply_augmentations
from geo_deep_learning_tpu_torch.ops.cuda.preprocess import fused_normalize_standardize
from geo_deep_learning_tpu_torch.ops.metrics import confusion_matrix, logits_to_preds
from geo_deep_learning_tpu_torch.parallel.collectives import average_over_model_, batch_context
from geo_deep_learning_tpu_torch.training.optim import (
    Schedule,
    clip_by_global_norm_,
    set_learning_rate,
)
from geo_deep_learning_tpu_torch.training.task import SegmentationTask


# batch keys that go to the device; names and counts stay on the host
_DEVICE_KEYS = ("image", "mask", "mean", "std", "wavelengths")


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays or tensors on ``device``; masks as int64, torch's
    index type (the shard stream's are int32, as in the JAX package). A
    pinned tensor (worker processes' batches) is copied without blocking."""
    out = dict(batch)
    for key in _DEVICE_KEYS:
        if key not in batch:
            continue
        value = batch[key]
        if isinstance(value, torch.Tensor):
            dtype = torch.int64 if key == "mask" else None
            out[key] = value.to(device, dtype=dtype, non_blocking=value.is_pinned())
        else:
            dtype = np.int64 if key == "mask" else None
            out[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=dtype)).to(device)
    return out


def prepare_image(batch: dict, precision: PrecisionPolicy) -> torch.Tensor:
    """NHWC batch image -> NHWC image in the compute dtype."""
    image = batch["image"]
    if image.dtype == torch.uint8:
        return fused_normalize_standardize(
            image, batch["mean"], batch["std"], out_dtype=precision.compute_dtype
        )
    return precision.cast_input(image)


def _forward(task: SegmentationTask, precision: PrecisionPolicy, batch: dict, image,
             module: torch.nn.Module | None = None):
    image = image.permute(0, 3, 1, 2)
    with precision.autocast(image.device):
        if module is None:
            return task.forward(batch, image)
        return module(*task.model_args(batch, image))


def _rows(batch: dict) -> tuple[int, int] | None:
    """``(row_offset, global_rows)`` of a rank's block, else None."""
    if "global_rows" not in batch:
        return None
    return int(batch["row_offset"]), int(batch["global_rows"])


def wrap_data_parallel(model: torch.nn.Module, mesh: Mesh | None):
    """``model`` under ``DistributedDataParallel`` over the mesh's data
    group (under tensor parallelism each model rank's DDP holds its own
    shards, averaged with the same shards of the other data indices), or
    None without a data group of several ranks. ``find_unused_parameters``:
    some parameters get no gradient by design (DOFA's final encoder norm,
    which no tapped output passes through)."""
    if mesh is None or mesh.group is None:
        return None
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(model, process_group=mesh.group, broadcast_buffers=False,
                                   init_sync=False, find_unused_parameters=True)


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
    mesh: Mesh | None = None,
) -> Callable[[TrainState, dict], dict]:
    """``(state, batch) -> {"loss"}``; updates ``state`` in place.

    ``schedule`` maps the number of optimizer updates done so far to the
    LR; without it the optimizer's LR stands (the plateau controller, when
    there is one, sets it between epochs). With a ``mesh`` that has a
    group, the model is driven through ``DistributedDataParallel``.
    """
    ddp = wrap_data_parallel(task.model, mesh)
    model_group = mesh.model_group if mesh is not None and mesh.tensor_parallel else None

    def train_step(state: TrainState, batch: dict) -> dict:
        task.model.train()
        last = (state.step + 1) % accumulate == 0
        sync = contextlib.nullcontext() if ddp is None or last else ddp.no_sync()
        with batch_context(mesh, batch), sync:
            image = prepare_image(batch, precision)
            mask = batch["mask"]
            if augment is not None:
                image, mask = apply_augmentations(state.aug_generator, image, mask, augment,
                                                  rows=_rows(batch))
            loss = task.compute_loss(_forward(task, precision, batch, image, ddp), mask)
            loss.backward()
        state.step += 1
        if state.step % accumulate == 0:
            params = [p for g in state.optimizer.param_groups for p in g["params"]]
            if model_group is not None:
                average_over_model_([p.grad for p in params if p.grad is not None
                                     and getattr(p, "model_split", None) is None],
                                    model_group, mesh.model_size)
            if accumulate > 1:
                torch._foreach_div_([p.grad for p in params if p.grad is not None], accumulate)
            if grad_clip:
                clip_by_global_norm_(params, grad_clip, model_group)
            if schedule is not None:
                set_learning_rate(state.optimizer, schedule(state.step // accumulate - 1))
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach().float()}

    train_step.ddp = ddp  # the DistributedDataParallel wrapper, or None
    return train_step


def make_eval_step(
    task: SegmentationTask, precision: PrecisionPolicy, mesh: Mesh | None = None
) -> Callable[[dict], dict]:
    """``batch -> {"loss", "confusion", "preds"}`` on the batch's device;
    the loss is the global batch's, the confusion matrix this rank's."""

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        with batch_context(mesh, batch):
            return _eval_step(batch)

    def _eval_step(batch: dict) -> dict:
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
