"""Plain building blocks shared by the reference models (f32, NCHW).

Written from the published descriptions, not from the program: BatchNorm
in train mode normalizes with the batch mean and the biased batch
variance, in eval mode with the running statistics; the bilinear resize
is half-pixel sampling without antialiasing (``F.interpolate``); GELU is
the tanh approximation that the JAX package took from flax (the published
DOFA and MiT use the exact erf form: a departure of the program that the
reference follows, since the comparison is of the port's arithmetic).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def batch_norm(x: torch.Tensor, P: dict, name: str, train: bool) -> torch.Tensor:
    w, b = P[f"{name}.weight"][:, None, None], P[f"{name}.bias"][:, None, None]
    if train:
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    else:
        mean = P[f"{name}.running_mean"][:, None, None]
        var = P[f"{name}.running_var"][:, None, None]
    return (x - mean) / torch.sqrt(var + BN_EPS) * w + b


def resize(x: torch.Tensor, size) -> torch.Tensor:
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=False)


def conv_module(M, P: dict, name: str, x: torch.Tensor, k: int, train: bool) -> torch.Tensor:
    """Conv (k x k, 'same' padding, bias where the parameters have one) +
    BatchNorm + ReLU."""
    y = M.conv2d(x, P[f"{name}.conv.weight"], P.get(f"{name}.conv.bias"), padding=k // 2)
    return torch.relu(batch_norm(y, P, f"{name}.norm", train))


def dice_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
              eps: float = 1e-7) -> torch.Tensor:
    """Soft multiclass Dice over batch and space jointly, averaged over
    classes: ``1 - 2 sum(p t) / sum(p + t)``, p the softmax, t the one-hot
    target."""
    b = logits.shape[0]
    p = torch.softmax(logits, dim=1).reshape(b, num_classes, -1)
    t = F.one_hot(target.reshape(b, -1).long(), num_classes).permute(0, 2, 1).to(p.dtype)
    inter = (p * t).sum(dim=(0, 2))
    card = (p + t).sum(dim=(0, 2))
    return (1.0 - 2.0 * inter / torch.clamp(card, min=eps)).mean()


def dice_binary(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                eps: float = 1e-7) -> torch.Tensor:
    """Soft binary Dice over batch and space jointly: ``1 - 2 sum(p t) /
    max(sum(p + t), eps)``, p the sigmoid of the single logit channel, t
    the {0, 1} mask."""
    if logits.shape[1] != 1 or num_classes != 1:
        raise ValueError(f"binary Dice takes one class and one logit channel, got "
                         f"{num_classes} and {logits.shape[1]}")
    p = torch.sigmoid(logits[:, 0]).reshape(-1)
    t = target.reshape(-1).to(p.dtype)
    return 1.0 - 2.0 * (p * t).sum() / torch.clamp((p + t).sum(), min=eps)


# a configuration's ``"loss"`` -> its plain reference, called as
# ``loss(logits, target, num_classes)``
LOSSES = {"dice_multiclass": dice_loss, "dice_binary": dice_binary}


def loss_of(cfg: dict):
    """The reference loss that the configuration's ``"loss"`` names."""
    name = cfg.get("loss")
    if name not in LOSSES:
        raise ValueError(f"configuration {cfg.get('name')!r}: \"loss\" is {name!r}, "
                         f"which names no reference loss ({', '.join(sorted(LOSSES))})")
    return LOSSES[name]


def normalize_nhwc(image_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> ``(x / 255 - mean) / std`` in f32, NCHW."""
    x = image_u8.float() / 255.0
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)
