"""Fused uint8 decode -> normalize -> standardize (kernel K1).

Port of ``geo_deep_learning_tpu/ops/pallas/preprocess.py``: the data path
ships raw uint8 pixels and the step turns them into the compute dtype in
one pass::

    out = (x * (1/255) - mean[b, c]) * (1 / std[b, c])

Layout stays NHWC, as at the JAX package's boundary. The CUDA kernel is
``csrc/preprocess.cu``; :func:`normalize_reference` is its plain PyTorch
version, used for CPU tensors and as the kernel's expected value.
"""

from __future__ import annotations

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "preprocess"


def _stats(mean, std, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ``[B, C]`` f32 mean and inverse std on the image's device."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=image.device)
    b, c = image.shape[0], image.shape[-1]
    if mean.ndim == 1:
        mean, std = mean[None], std[None]
    if mean.shape != std.shape or mean.ndim != 2 or mean.shape[0] not in (1, b) or mean.shape[1] != c:
        msg = f"mean/std must be [C] or [B, C] = [{b}, {c}], got {tuple(mean.shape)}"
        raise ValueError(msg)
    mean, std = mean.expand(b, c), std.expand(b, c)
    return mean.contiguous(), (1.0 / std).contiguous()


def normalize_reference(
    image: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor, out_dtype
) -> torch.Tensor:
    """Plain version: ``[B,H,W,C]`` uint8 + ``[B,C]`` mean / inverse std."""
    x = image.to(torch.float32) * (1.0 / 255.0)
    x = (x - mean[:, None, None, :]) * inv_std[:, None, None, :]
    return x.to(out_dtype)


def _launch(image, mean, inv, out_dtype) -> torch.Tensor:
    _lib.require_cuda(image, KERNEL)
    if image.dtype != torch.uint8 or image.ndim != 4:
        msg = f"{KERNEL}: expected a [B,H,W,C] uint8 image, got {image.dtype} {tuple(image.shape)}"
        raise ValueError(msg)
    if out_dtype not in (torch.bfloat16, torch.float32):
        msg = f"{KERNEL}: out_dtype must be bfloat16 or float32, got {out_dtype}"
        raise ValueError(msg)
    image = image.contiguous()
    b, h, w, c = image.shape
    n = h * w * c
    out = torch.empty(image.shape, dtype=out_dtype, device=image.device)
    vec = int(n % 16 == 0 and image.data_ptr() % 16 == 0)
    code = _lib.library().gdl_preprocess(
        image.data_ptr(), mean.data_ptr(), inv.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), b, n, c, vec, _lib.stream_ptr(image),
    )
    _lib.check(code, KERNEL)
    return out


def fused_normalize_standardize(
    image: torch.Tensor, mean, std, out_dtype=torch.float32
) -> torch.Tensor:
    """uint8 ``[B,H,W,C]`` + ``[C]`` or ``[B,C]`` stats -> normalized NHWC.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    mean, inv = _stats(mean, std, image)
    if image.device.type == "cpu":
        return normalize_reference(image, mean, inv, out_dtype)
    return _launch(image, mean, inv, out_dtype)
