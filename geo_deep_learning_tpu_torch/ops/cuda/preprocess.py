"""Fused uint8 decode -> normalize -> standardize (kernel K1).

Port of ``geo_deep_learning_tpu/ops/pallas/preprocess.py``: the data path
ships raw uint8 pixels and the step turns them into the compute dtype in
one pass::

    out = (x * (1/255) - mean[b, c]) * (1 / std[b, c])

Layout stays NHWC, as at the JAX package's boundary. The CUDA kernel is
``csrc/preprocess.cu``; :func:`normalize_reference` is its plain PyTorch
version, used for CPU tensors and as the kernel's expected value; the
``gdl::preprocess`` operator dispatches between them.

On the card a call is one launch: the kernel takes ``mean`` and ``std`` as
given (``[C]`` or ``[B, C]`` f32) and inverts ``std`` itself, so the
wrapper runs no torch kernel before it. Persistent blocks stream tiles of
one sample through a ring of shared-memory stages (block p takes tiles p,
p + grid, ...); the tile and the ring's depth are the kernel's constants.
"""

from __future__ import annotations

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "preprocess"


def _stats(mean, std, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ``[B, C]`` f32 mean and inverse std on the image's device."""
    mean, std = _check_stats(mean, std, image)
    b, c = image.shape[0], image.shape[-1]
    if mean.ndim == 1:
        mean, std = mean[None], std[None]
    mean, std = mean.expand(b, c), std.expand(b, c)
    return mean.contiguous(), (1.0 / std).contiguous()


def _check_stats(mean, std, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``mean``/``std`` as f32 tensors on the image's device, ``[C]`` or
    ``[B, C]`` (or ``[1, C]``); raises on any other shape."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=image.device)
    b, c = image.shape[0], image.shape[-1]
    ok = mean.shape == std.shape and (
        mean.shape == (c,) or (mean.ndim == 2 and mean.shape[0] in (1, b) and mean.shape[1] == c))
    if not ok:
        msg = (f"mean/std must be [C] or [B, C] = [{b}, {c}], "
               f"got {tuple(mean.shape)} and {tuple(std.shape)}")
        raise ValueError(msg)
    return mean, std


def normalize_reference(
    image: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor, out_dtype
) -> torch.Tensor:
    """Plain version: ``[B,H,W,C]`` uint8 + ``[B,C]`` mean / inverse std."""
    x = image.to(torch.float32) * (1.0 / 255.0)
    x = (x - mean[:, None, None, :]) * inv_std[:, None, None, :]
    return x.to(out_dtype)


def _check(image: torch.Tensor, out_dtype) -> None:
    if image.dtype != torch.uint8 or image.ndim != 4:
        msg = f"{KERNEL}: expected a [B,H,W,C] uint8 image, got {image.dtype} {tuple(image.shape)}"
        raise ValueError(msg)
    if out_dtype not in (torch.bfloat16, torch.float32):
        msg = f"{KERNEL}: out_dtype must be bfloat16 or float32, got {out_dtype}"
        raise ValueError(msg)


def _launch(image, mean, std, out_dtype) -> torch.Tensor:
    """One launch of K1 on the image's ``[C]`` or ``[B, C]`` statistics."""
    _check(image, out_dtype)
    mean, std = _check_stats(mean, std, image)
    image, mean, std = image.contiguous(), mean.contiguous(), std.contiguous()
    b, h, w, c = image.shape
    n = h * w * c
    out = torch.empty(image.shape, dtype=out_dtype, device=image.device)
    stat_stride = c if mean.ndim == 2 and mean.shape[0] > 1 else 0
    # the bulk-copy path needs 16-byte aligned samples; else the generic one
    bulk = int(n % 16 == 0 and image.data_ptr() % 16 == 0)
    code = _lib.library().gdl_preprocess(
        image.data_ptr(), mean.data_ptr(), std.data_ptr(), stat_stride, out.data_ptr(),
        int(out_dtype == torch.bfloat16), b, n, c, bulk, _lib.stream_ptr(image),
    )
    _lib.check(code, KERNEL)
    return out


def _fake(image, mean, std, out_dtype) -> torch.Tensor:
    _check(image, out_dtype)
    return image.new_empty(image.shape, dtype=out_dtype)


PREPROCESS = _lib.define(
    f"{KERNEL}(Tensor image, Tensor mean, Tensor std, ScalarType out_dtype) -> Tensor",
    cpu=lambda image, mean, std, out_dtype: normalize_reference(
        image, *_stats(mean, std, image), out_dtype),
    cuda=_launch, fake=_fake)


def fused_normalize_standardize(
    image: torch.Tensor, mean, std, out_dtype=torch.float32
) -> torch.Tensor:
    """uint8 ``[B,H,W,C]`` + ``[C]`` or ``[B,C]`` stats -> normalized NHWC.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(image, out_dtype)
    mean, std = _check_stats(mean, std, image)
    _lib.require_device(image, KERNEL)
    return PREPROCESS(image, mean, std, out_dtype)
