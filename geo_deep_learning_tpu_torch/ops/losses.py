"""Soft Dice loss with smp-compatible aggregation.

Port of ``dice_loss`` / ``DiceLoss`` in ``geo_deep_learning_tpu/ops/losses.py``.
Logits are NCHW ``[B, C, H, W]`` (``[B, 1, H, W]`` binary), targets
``[B, H, W]`` integer class maps; the loss is an f32 scalar. Per-class
dice is computed over batch and space jointly, then averaged over classes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-7

BINARY_MODE = "binary"
MULTICLASS_MODE = "multiclass"


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
    logits = logits.float()
    b, c = logits.shape[:2]
    if mode == BINARY_MODE:
        probs = torch.sigmoid(logits)
    else:
        probs = torch.exp(F.log_softmax(logits, dim=1))
    probs = probs.reshape(b, c, -1)  # [B, C, HW]
    t = targets.reshape(b, 1, -1)
    if mode == BINARY_MODE:
        onehot = t.float()
    else:
        onehot = F.one_hot(t[:, 0].clamp(0, c - 1), c).permute(0, 2, 1).float()
        onehot = onehot * (t >= 0) * (t < c)
    if ignore_index is not None:
        valid = (t != ignore_index).float()
        probs = probs * valid
        onehot = onehot * valid
    if sample_weights is not None:
        w = sample_weights.float().reshape(b, 1, 1)
        probs = probs * w
        onehot = onehot * w
    intersection = (probs * onehot).sum(dim=(0, 2))
    cardinality = (probs + onehot).sum(dim=(0, 2))
    dice = (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth, min=eps)
    loss = -torch.log(torch.clamp(dice, min=eps)) if log_loss else 1.0 - dice
    return loss.mean()


class DiceLoss:
    """Config-surface wrapper naming the loss as smp does (``init_args``
    are :func:`dice_loss` keywords)."""

    def __init__(self, **kwargs) -> None:
        self.kwargs = kwargs

    def __call__(self, logits, targets, sample_weights=None):
        return dice_loss(logits, targets, sample_weights=sample_weights, **self.kwargs)

    def __repr__(self) -> str:
        return f"DiceLoss({self.kwargs})"
