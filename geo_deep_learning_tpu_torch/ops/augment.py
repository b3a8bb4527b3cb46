"""Joint image/mask augmentation on the device.

Port of ``geo_deep_learning_tpu/ops/augment.py`` (reference Kornia pipeline,
``segmentation_dofa.py:91-121``): ``random_apply=1`` over HFlip, VFlip,
RandomRotation90 and two RandomResizedCrops (zoom-in scale (1, 2), zoom-out
(0.5, 1)), each with its own per-sample probability ``p``. One transform is
chosen per batch; it then gates itself per sample.

The random parameters are drawn on the host from a CPU ``torch.Generator``
(a handful of numbers per batch) and moved to the image's device; the
transforms run there. Resized crops are the JAX package's separable
coordinate-grid resample, written out: bilinear tent weights for the image,
nearest one-hot selection for the mask, zeros outside the source.

Contract: ``image`` is NHWC float, ``mask`` is ``[B, H, W]`` integer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


def hflip(img, mask):
    return img.flip(2), mask.flip(2)


def vflip(img, mask):
    return img.flip(1), mask.flip(1)


def rot90_batch(img, mask, k: torch.Tensor):
    """Per-sample rotation by ``k`` quarter turns, ``k`` in {0, 1, 2, 3}
    (square inputs), as the JAX package composes it from transposes and
    flips."""
    r_i = (img.transpose(1, 2).flip(1), img.flip(1).flip(2), img.transpose(1, 2).flip(2))
    r_m = (mask.transpose(1, 2).flip(1), mask.flip(1).flip(2), mask.transpose(1, 2).flip(2))
    img_out, mask_out = img, mask
    for turns, (ri, rm) in enumerate(zip(r_i, r_m), start=1):
        sel = k == turns
        img_out = torch.where(sel[:, None, None, None], ri, img_out)
        mask_out = torch.where(sel[:, None, None], rm, mask_out)
    return img_out, mask_out


def grid_sample_crop(img, mask, y0, x0, crop_h, crop_w):
    """Resample the per-sample crop box (pixel units, may leave the source)
    back to full size: bilinear image, nearest mask, zeros outside."""
    h, w = img.shape[1], img.shape[2]
    dev = img.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    src_y = y0[:, None] + ys[None, :] * crop_h[:, None] - 0.5  # [B, H]
    src_x = x0[:, None] + xs[None, :] * crop_w[:, None] - 0.5  # [B, W]
    j_h = torch.arange(h, dtype=torch.float32, device=dev)
    j_w = torch.arange(w, dtype=torch.float32, device=dev)
    wy = torch.clamp(1.0 - (src_y[:, :, None] - j_h[None, None, :]).abs(), min=0.0)
    wx = torch.clamp(1.0 - (src_x[:, :, None] - j_w[None, None, :]).abs(), min=0.0)
    out = torch.einsum("bij,bjwc->biwc", wy, img.float())
    out = torch.einsum("bxw,biwc->bixc", wx, out).to(img.dtype)
    ny = (torch.round(src_y)[:, :, None] == j_h[None, None, :]).float()
    nx = (torch.round(src_x)[:, :, None] == j_w[None, None, :]).float()
    m = torch.einsum("bij,bjw->biw", ny, mask.float())
    m = torch.einsum("bxw,biw->bix", nx, m)
    return out, torch.round(m).to(mask.dtype)


def crop_box(u, h: int, w: int, scale, ratio):
    """Crop boxes from uniform draws ``u = (area, log-ratio, y, x)``, each
    ``[B]`` in [0, 1): area in ``scale`` x h x w, aspect log-uniform in
    ``ratio``; the origin is uniform when the box fits, else the overhang
    is centred. Returns ``(y0, x0, crop_h, crop_w)``."""
    u_area, u_ratio, u_y, u_x = u
    area = (scale[0] + (scale[1] - scale[0]) * u_area) * h * w
    lo, hi = torch.log(torch.tensor(ratio[0])), torch.log(torch.tensor(ratio[1]))
    aspect = torch.exp(lo + (hi - lo) * u_ratio)
    crop_w = torch.sqrt(area * aspect)
    crop_h = torch.sqrt(area / aspect)
    max_y, max_x = h - crop_h, w - crop_w
    y0 = torch.where(max_y > 0, u_y * torch.clamp(max_y, min=0), max_y / 2.0)
    x0 = torch.where(max_x > 0, u_x * torch.clamp(max_x, min=0), max_x / 2.0)
    return y0, x0, crop_h, crop_w


@dataclass(frozen=True)
class AugmentConfig:
    """The reference pipeline's transform list and probabilities."""

    p: float = 0.5  # each transform's own probability
    rot90_times: tuple[int, int] = (1, 3)
    zoom_in_scale: tuple[float, float] = (1.0, 2.0)
    zoom_out_scale: tuple[float, float] = (0.5, 1.0)
    ratio: tuple[float, float] = field(default=(3.0 / 4.0, 4.0 / 3.0))


def apply_augmentations(
    generator: torch.Generator,
    image: torch.Tensor,
    mask: torch.Tensor,
    config: AugmentConfig | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply one randomly chosen transform, gated per sample with ``p``.

    ``generator`` is a CPU generator; the draws (transform index, gates,
    parameters) go to the image's device.
    """
    cfg = config or AugmentConfig()
    b, h, w = image.shape[0], image.shape[1], image.shape[2]
    dev = image.device
    idx = int(torch.randint(0, 5, (), generator=generator))
    apply = (torch.rand(b, generator=generator) < cfg.p).to(dev)
    if idx == 0:
        aug_img, aug_mask = hflip(image, mask)
    elif idx == 1:
        aug_img, aug_mask = vflip(image, mask)
    elif idx == 2:
        lo, hi = cfg.rot90_times
        k = torch.randint(lo, hi + 1, (b,), generator=generator).to(dev)
        aug_img, aug_mask = rot90_batch(image, mask, k)
    else:
        scale = cfg.zoom_in_scale if idx == 3 else cfg.zoom_out_scale
        u = torch.rand((4, b), generator=generator)
        box = (t.to(dev) for t in crop_box(u, h, w, scale, cfg.ratio))
        aug_img, aug_mask = grid_sample_crop(image, mask, *box)
    image = torch.where(apply[:, None, None, None], aug_img, image)
    mask = torch.where(apply[:, None, None], aug_mask, mask)
    return image, mask
