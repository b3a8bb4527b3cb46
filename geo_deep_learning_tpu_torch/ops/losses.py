"""Segmentation losses with smp / torch semantics.

Port of ``geo_deep_learning_tpu/ops/losses.py``: Dice, Jaccard, soft
(label-smoothed) cross entropy, cross entropy with class weights and
``ignore_index``, binary cross entropy with logits, and focal loss, each
with its configured class (what a config's ``class_path`` names). Logits
are NCHW ``[B, C, H, W]`` (``[B, 1, H, W]`` binary), targets ``[B, H, W]``
integer class maps ({0, 1} binary). Losses compute in f32 (f64 inputs stay
f64) and return a scalar. ``sample_weights`` (``[B]``, 0/1) removes padded
tail samples exactly, as ``valid_count`` does in the confusion matrix.

Every sum over the batch goes through ``parallel.collectives.global_sum``,
so on a batch split over ranks a loss is the global batch's (as GSPMD
computes it in the JAX package: the mean of per-rank Dice losses is not
the global Dice); without a group nothing changes.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from geo_deep_learning_tpu_torch.parallel.collectives import global_mean, global_sum

_EPS = 1e-7

BINARY_MODE = "binary"
MULTICLASS_MODE = "multiclass"


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def _sample_w(sample_weights, targets: torch.Tensor) -> torch.Tensor | None:
    """Per-sample weight broadcastable as ``[B, 1, ...]`` (None if absent)."""
    if sample_weights is None:
        return None
    w = _float(torch.as_tensor(sample_weights, device=targets.device))
    return w.reshape((targets.shape[0],) + (1,) * (targets.ndim - 1))


def _soft_probs(logits: torch.Tensor, mode: str) -> torch.Tensor:
    logits = _float(logits)
    if mode == BINARY_MODE:
        return torch.sigmoid(logits)
    return torch.exp(F.log_softmax(logits, dim=1))  # smp's log_softmax().exp()


def _onehot(targets: torch.Tensor, c: int, mode: str) -> torch.Tensor:
    """``[B, C, HW]`` targets; a class index outside ``[0, C)`` is all zero."""
    t = targets.reshape(targets.shape[0], 1, -1)
    if mode == BINARY_MODE:
        return t.float()
    onehot = F.one_hot(t[:, 0].clamp(0, c - 1), c).permute(0, 2, 1).float()
    return onehot * (t >= 0) * (t < c)


def _mean_weighted(per_pixel: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    if weights is None:
        return global_mean(per_pixel)
    weights = weights.expand_as(per_pixel)
    return _ratio(per_pixel * weights, weights)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``sum(num) / max(sum(den), 1)``, both sums global."""
    num, den = global_sum(torch.stack([num.sum(), den.sum()]))
    return num / torch.clamp(den, min=1.0)


def dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mode: str = MULTICLASS_MODE,
    smooth: float = 0.0,
    eps: float = _EPS,
    log_loss: bool = False,
    ignore_index: int | None = None,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Soft Dice: per-class dice over batch and space jointly, averaged
    over classes (smp's ``DiceLoss`` aggregation)."""
    b, c = logits.shape[:2]
    probs = _soft_probs(logits, mode).reshape(b, c, -1)  # [B, C, HW]
    onehot = _onehot(targets, c, mode)
    t = targets.reshape(b, 1, -1)
    if ignore_index is not None:
        valid = (t != ignore_index).float()
        probs = probs * valid
        onehot = onehot * valid
    if sample_weights is not None:
        w = _float(sample_weights).reshape(b, 1, 1)
        probs = probs * w
        onehot = onehot * w
    intersection, cardinality = global_sum(
        torch.stack([(probs * onehot).sum(dim=(0, 2)), (probs + onehot).sum(dim=(0, 2))]))
    dice = (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth, min=eps)
    loss = -torch.log(torch.clamp(dice, min=eps)) if log_loss else 1.0 - dice
    return loss.mean()


def jaccard_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mode: str = MULTICLASS_MODE,
    smooth: float = 0.0,
    eps: float = _EPS,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Soft IoU (Jaccard) loss, aggregated as :func:`dice_loss`."""
    b, c = logits.shape[:2]
    probs = _soft_probs(logits, mode).reshape(b, c, -1)
    onehot = _onehot(targets, c, mode)
    if sample_weights is not None:
        w = _float(sample_weights).reshape(b, 1, 1)
        probs = probs * w
        onehot = onehot * w
    intersection, total = global_sum(
        torch.stack([(probs * onehot).sum(dim=(0, 2)), (probs + onehot).sum(dim=(0, 2))]))
    union = total - intersection
    iou = (intersection + smooth) / torch.clamp(union + smooth, min=eps)
    return (1.0 - iou).mean()


def soft_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    smooth_factor: float = 0.0,
    ignore_index: int | None = None,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Label-smoothed cross entropy (smp ``SoftCrossEntropyLoss``): the
    target is ``(1 - s) * onehot + s / C``."""
    logits = _float(logits)
    b, c = logits.shape[:2]
    log_probs = F.log_softmax(logits, dim=1)
    onehot = _onehot(targets, c, MULTICLASS_MODE).reshape(log_probs.shape)
    soft = (1.0 - smooth_factor) * onehot + smooth_factor / c
    nll = -(soft * log_probs).sum(dim=1)  # [B, H, W]
    weights = _sample_w(sample_weights, targets)
    if ignore_index is not None:
        valid = (targets != ignore_index).to(nll.dtype)
        weights = valid if weights is None else weights * valid
    return _mean_weighted(nll, weights)


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int | None = None,
    class_weights=None,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multiclass cross entropy, ``sum(w * nll) / max(sum(w), 1)`` with the
    weight the product of class weight, not-ignored mask and sample weight."""
    logits = _float(logits)
    log_probs = F.log_softmax(logits, dim=1)
    # clamped so that an ignore_index such as 255 stays a valid gather index;
    # its weight below is 0
    safe = targets.clamp(0, logits.shape[1] - 1)
    nll = -log_probs.gather(1, safe[:, None])[:, 0]
    weights = torch.ones_like(nll)
    if class_weights is not None:
        weights = weights * torch.as_tensor(class_weights, dtype=nll.dtype, device=nll.device)[safe]
    if ignore_index is not None:
        weights = weights * (targets != ignore_index)
    sw = _sample_w(sample_weights, targets)
    if sw is not None:
        weights = weights * sw
    return _ratio(nll * weights, weights)


def binary_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """BCE with logits over ``[B, 1, H, W]`` logits and {0, 1} targets."""
    x = _float(logits).squeeze(1)
    t = targets.to(x.dtype)
    loss = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return _mean_weighted(loss, _sample_w(sample_weights, t))


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mode: str = MULTICLASS_MODE,
    alpha: float | None = None,
    gamma: float = 2.0,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Focal loss, binary (sigmoid) or multiclass (softmax)."""
    logits = _float(logits)
    if mode == BINARY_MODE:
        p = torch.sigmoid(logits.squeeze(1))
        t = targets.to(p.dtype)
        pt = p * t + (1 - p) * (1 - t)
        ce = -torch.log(torch.clamp(pt, min=_EPS))
        w = (1 - pt) ** gamma
        if alpha is not None:
            w = w * (alpha * t + (1 - alpha) * (1 - t))
        per_pixel = w * ce
    else:
        logpt = F.log_softmax(logits, dim=1).gather(1, targets[:, None])[:, 0]
        w = (1 - torch.exp(logpt)) ** gamma
        if alpha is not None:
            w = w * alpha
        per_pixel = -w * logpt
    return _mean_weighted(per_pixel, _sample_w(sample_weights, targets))


class _ConfiguredLoss:
    """Config-surface wrapper naming a loss as smp / torch name theirs;
    ``init_args`` are the function's keywords."""

    fn: Callable

    def __init__(self, **kwargs) -> None:
        self.kwargs = kwargs

    def __call__(self, logits, targets, sample_weights=None):
        return type(self).fn(logits, targets, sample_weights=sample_weights, **self.kwargs)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.kwargs})"


class DiceLoss(_ConfiguredLoss):
    fn = staticmethod(dice_loss)


class JaccardLoss(_ConfiguredLoss):
    fn = staticmethod(jaccard_loss)


class SoftCrossEntropyLoss(_ConfiguredLoss):
    fn = staticmethod(soft_cross_entropy)


class CrossEntropyLoss(_ConfiguredLoss):
    fn = staticmethod(cross_entropy)


class BinaryCrossEntropyLoss(_ConfiguredLoss):
    fn = staticmethod(binary_cross_entropy)


class FocalLoss(_ConfiguredLoss):
    fn = staticmethod(focal_loss)
