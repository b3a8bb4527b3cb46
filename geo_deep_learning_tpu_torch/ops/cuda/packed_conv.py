"""W-packed 3x3 conv with fused BatchNorm-train statistics (kernel K11).

Port of ``geo_deep_learning_tpu/ops/pallas/packed_conv.py``. A 64-channel
NHWC map ``[B, H, W, 64]`` is viewed W-packed as ``[B, H, W/2, 128]``
(:func:`pack_nhwc`, a reshape: each packed position holds a pixel pair), and
a 3x3 conv of the map becomes a 3x3 conv of the packed tensor with the
``[3, 3, 128, 128]`` block kernel of :func:`pack_w_kernel` (exact math, with
structural zeros). One leg of the UNet++ finest-column measurement
(``tools/bench_column.py``) is :func:`packed_conv_bn_stats`:

- an optional prologue ``relu(x * scale + shift)`` in f32 per packed slot,
  rounded back to ``x.dtype``;
- a zero halo added after the prologue;
- the packed conv, accumulated in f32, ``y`` stored in ``x.dtype``;
- ``stats = [sum(y), sum(y^2)]`` per packed slot over ``(B, H, Wp)``, from
  the f32 accumulator before ``y`` is rounded (``None`` without
  ``accumulate_stats``).

:func:`packed_conv_bn_stats_plain` is the kernel's plain version, used for
CPU tensors and as the kernel's expected value; the CUDA kernel is
``csrc/packed_conv.cu``, which skips the all-zero 64 x 64 blocks of the
block kernel (:func:`block_flags`). Forward only, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "packed_conv_bn_stats"
PACKED = 128  # packed channels: two slots of 64


def pack_w_kernel(k: torch.Tensor) -> torch.Tensor:
    """``[3, 3, C, O]`` (HWIO) -> ``[3, 3, 2C, 2O]`` W-packed block kernel.

    Rows index input (pair-slot) blocks, columns output slots::

        out_even = K0 * x_even + K+1 * x_odd + K-1 * (left pair's odd)
        out_odd  = K-1 * x_even + K0 * x_odd + K+1 * (right pair's even)
    """
    kh, _, c, o = k.shape
    z = k.new_zeros((kh, c, o))
    km1, k0, kp1 = k[:, 0], k[:, 1], k[:, 2]

    def blk(a, b, cc, d):  # [[a, b], [cc, d]] over (in-slot, out-slot)
        return torch.cat([torch.cat([a, b], dim=-1), torch.cat([cc, d], dim=-1)], dim=-2)

    return torch.stack([blk(z, z, km1, z), blk(k0, km1, kp1, k0), blk(z, kp1, z, z)], dim=1)


def block_flags(kp: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's pre-pass: which 64 x 64 blocks of a
    ``[3, 3, 128, 128]`` kernel hold a non-zero value (a NaN counts; -0 does
    not), as a ``[3, 3, 2, 2]`` bool over (dh, dw, in-slot, out-slot). The
    kernel multiplies exactly the flagged blocks: the 18 that
    :func:`pack_w_kernel` fills, for a block kernel it made."""
    return (kp.reshape(3, 3, 2, 64, 2, 64) != 0).any(dim=5).any(dim=3)


def pack_nhwc(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, H, W/2, 2C]`` (a reshape of NHWC memory)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w // 2, 2 * c)


def unpack_nhwc(x: torch.Tensor) -> torch.Tensor:
    b, h, wp, c2 = x.shape
    return x.reshape(b, h, wp * 2, c2 // 2)


def _check_shapes(x: torch.Tensor, kp: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[-1] != PACKED:
        msg = f"{KERNEL}: expected a packed [B, H, Wp, {PACKED}] input, got {tuple(x.shape)}"
        raise ValueError(msg)
    if tuple(kp.shape) != (3, 3, PACKED, PACKED):
        msg = f"{KERNEL}: expected a [3, 3, {PACKED}, {PACKED}] block kernel, got {tuple(kp.shape)}"
        raise ValueError(msg)


def packed_conv_bn_stats_plain(x, kp, scale, shift, apply_bn_relu: bool = True,
                               accumulate_stats: bool = True):
    """Plain version of K11: the kernel's arithmetic in PyTorch. The conv is
    ``F.conv2d`` in f32 (TF32 off) on the prologue's rounded output."""
    _check_shapes(x, kp)
    with torch.autocast(device_type=x.device.type, enabled=False), \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        acc = _lib.acc_dtype(x.dtype)
        xin = x
        if apply_bn_relu:
            xin = torch.relu(x.to(acc) * scale.to(acc) + shift.to(acc)).to(x.dtype)
        yf = F.conv2d(xin.to(acc).permute(0, 3, 1, 2), kp.to(acc).permute(3, 2, 0, 1),
                      padding=1).permute(0, 2, 3, 1)
        stats = None
        if accumulate_stats:
            stats = torch.stack([yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))])
        return yf.to(x.dtype), stats


def _launch(x, kp, scale, shift, apply_bn_relu: bool, accumulate_stats: bool):
    _check_shapes(x, kp)
    for t in (x, kp):
        _lib.require_cuda(t, KERNEL)
        if t.dtype != torch.bfloat16:
            msg = f"{KERNEL}: the kernel takes bfloat16 x and kp, got {x.dtype}, {kp.dtype}"
            raise ValueError(msg)
        _lib.require_aligned(t, KERNEL)
    b, h, wp, _ = x.shape
    lib = _lib.library()
    vectors = [v.detach().to(device=x.device, dtype=torch.float32).contiguous()
               for v in (scale, shift)]
    if any(v.shape != (PACKED,) for v in vectors):
        msg = f"{KERNEL}: scale and shift must be [{PACKED}]"
        raise ValueError(msg)
    blocks = lib.gdl_packed_conv_blocks(b, h, wp)
    if blocks < 1:
        msg = f"{KERNEL}: input {tuple(x.shape)} needs more than 2^31 - 1 blocks"
        raise ValueError(msg)
    y = torch.empty_like(x)
    part = stats = None
    if accumulate_stats:
        part = torch.empty((blocks, 2 * PACKED), dtype=torch.float32, device=x.device)
        stats = torch.empty((2, PACKED), dtype=torch.float32, device=x.device)
    code = lib.gdl_packed_conv_bn_stats(
        x.data_ptr(), kp.data_ptr(), vectors[0].data_ptr(), vectors[1].data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), None if stats is None else stats.data_ptr(),
        b, h, wp, blocks, int(apply_bn_relu), _lib.stream_ptr(x),
    )
    _lib.check(code, KERNEL)
    return y, stats


def packed_conv_bn_stats(x, kp, scale, shift, apply_bn_relu: bool = True,
                         accumulate_stats: bool = True):
    """One column leg: (BN + ReLU prologue) -> packed 3x3 conv -> statistics.

    ``x``: ``[B, H, Wp, 128]`` packed; ``kp``: ``[3, 3, 128, 128]`` block
    kernel; ``scale``, ``shift``: ``[128]`` fused BN scale and shift of the
    input. Returns ``(y, stats)``: ``y`` ``[B, H, Wp, 128]`` in ``x.dtype``,
    ``stats`` ``[2, 128]`` f32 or ``None``. K11 for CUDA tensors (bf16), its
    plain version for CPU tensors.
    """
    if x.device.type == "cpu":
        return packed_conv_bn_stats_plain(x, kp, scale, shift, apply_bn_relu, accumulate_stats)
    return _launch(x, kp, scale, shift, apply_bn_relu, accumulate_stats)
