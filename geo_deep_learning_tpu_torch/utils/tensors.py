"""Tensor utilities (channel-last), on the tensor's own device.

Port of ``geo_deep_learning_tpu/utils/tensors.py`` (reference
``utils/tensors.py:10-76``): images are NHWC / HWC, and ``mean`` / ``std``
are per-channel vectors placed on the channel axis (default last). Each
function works on a torch tensor and returns one on the same device; the
stats may be sequences, arrays or tensors. Bad stats and out-of-range
bands raise ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


def _channel_shape(ndim: int, channel_axis: int) -> list[int]:
    shape = [1] * ndim
    shape[channel_axis % ndim] = -1
    return shape


def normalization(
    input_tensor: torch.Tensor,
    image_min: float = 0.0,
    image_max: float = 255.0,
    norm_min: float = 0.0,
    norm_max: float = 1.0,
) -> torch.Tensor:
    """Min-max rescale from [image_min, image_max] to [norm_min, norm_max]:
    an affine map; values outside the source range are NOT clipped."""
    scale = (norm_max - norm_min) / (image_max - image_min)
    return (input_tensor - image_min) * scale + norm_min


def standardization(
    input_tensor: torch.Tensor,
    mean: Sequence[float] | torch.Tensor,
    std: Sequence[float] | torch.Tensor,
    channel_axis: int = -1,
) -> torch.Tensor:
    """Per-channel ``(x - mean) / std``; ``mean`` and ``std`` must be 1-D."""
    like = {"dtype": input_tensor.dtype, "device": input_tensor.device}
    mean = torch.as_tensor(mean, **like)
    std = torch.as_tensor(std, **like)
    if mean.ndim != 1 or std.ndim != 1:
        msg = (f"mean/std must be 1-D per-channel vectors, got "
               f"{tuple(mean.shape)}/{tuple(std.shape)}")
        raise ValueError(msg)
    shape = _channel_shape(input_tensor.ndim, channel_axis)
    return (input_tensor - mean.reshape(shape)) / std.reshape(shape)


def denormalization(
    image: torch.Tensor,
    mean: Sequence[float] | torch.Tensor | float | None = None,
    std: Sequence[float] | torch.Tensor | float | None = None,
    data_type_max: float = 255.0,
    channel_axis: int = -1,
) -> torch.Tensor:
    """Invert standardization (when both stats are given) and normalization,
    then clip and quantize to uint8 for display."""
    if mean is not None and std is not None:
        like = {"dtype": image.dtype, "device": image.device}
        shape = _channel_shape(image.ndim, channel_axis)
        mean = torch.atleast_1d(torch.as_tensor(mean, **like))
        std = torch.atleast_1d(torch.as_tensor(std, **like))
        image = image * std.reshape(shape) + mean.reshape(shape)
    return torch.clamp(image * data_type_max, 0, data_type_max).to(torch.uint8)


def manage_bands(
    image: torch.Tensor,
    band_indices: Sequence[int] | None = None,
    channel_axis: int = -1,
) -> torch.Tensor:
    """The bands ``band_indices`` of ``image``, in that order, along the
    channel axis; all of them when ``band_indices`` is None."""
    if band_indices is None:
        return image
    axis = channel_axis % image.ndim
    bands = image.shape[axis]
    if max(band_indices) >= bands:
        msg = f"Band index {max(band_indices)} is out of range for image with {bands} bands"
        raise ValueError(msg)
    index = torch.as_tensor(list(band_indices), dtype=torch.long, device=image.device)
    return image.index_select(axis, index)
