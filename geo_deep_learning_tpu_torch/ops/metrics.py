"""Segmentation metrics from a confusion matrix.

Port of ``geo_deep_learning_tpu/ops/metrics.py``: an additive ``[C, C]``
confusion matrix (rows = target, cols = prediction) accumulated over
batches gives dataset-level IoU, accuracy and F1.
"""

from __future__ import annotations

import torch


def confusion_matrix(
    preds: torch.Tensor,
    targets: torch.Tensor,
    num_classes: int,
    sample_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense ``[C, C]`` f32 confusion matrix; ``sample_weights`` ([B],
    e.g. 0/1 validity of padded samples) scales each sample's pixels.

    A pixel whose target or prediction lies outside ``[0, C)`` (an ignore
    label such as 255 or -1) counts nowhere, as the JAX package's one-hot
    rows of zeros do."""
    b = preds.shape[0]
    t = targets.reshape(b, -1).long()
    p = preds.reshape(b, -1).long()
    valid = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    idx = torch.where(valid, t * num_classes + p, 0)
    weights = valid.float()
    if sample_weights is not None:
        weights = weights * sample_weights.float()[:, None]
    cm = torch.bincount(idx.reshape(-1), weights=weights.reshape(-1), minlength=num_classes**2)
    return cm.float().reshape(num_classes, num_classes)


def iou_from_confusion(cm: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Per-class IoU; classes absent from target and prediction get NaN."""
    tp = torch.diagonal(cm)
    union = cm.sum(dim=0) + cm.sum(dim=1) - tp
    iou = tp / torch.clamp(union, min=eps)
    return torch.where(union > 0, iou, torch.full_like(iou, float("nan")))


def f1_from_confusion(cm: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    tp = torch.diagonal(cm)
    denom = cm.sum(dim=0) + cm.sum(dim=1)
    f1 = 2 * tp / torch.clamp(denom, min=eps)
    return torch.where(denom > 0, f1, torch.full_like(f1, float("nan")))


def accuracy_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    return torch.trace(cm) / torch.clamp(cm.sum(), min=1.0)


def logits_to_preds(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """``[B, C, H, W]`` logits -> ``[B, H, W]`` int64 classes: sigmoid >
    threshold when C == 1 (the reference's binary rule), else argmax."""
    if logits.shape[1] == 1:
        return (torch.sigmoid(logits[:, 0].float()) > threshold).long()
    return logits.argmax(dim=1)


def classwise(values: torch.Tensor, class_labels, prefix: str) -> dict[str, float]:
    """``{prefix_label: value}`` per class (the reference's naming)."""
    labels = list(class_labels) if class_labels else [str(i) for i in range(len(values))]
    return {f"{prefix}_{labels[i]}": float(values[i]) for i in range(len(values))}
