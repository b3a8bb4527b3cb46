"""Bilinear resize followed by a zero-padded 3x3 conv, computed in factored form.

Port of ``resize_conv3x3_factored`` (with ``_interp_rows`` and
``_shifted_interp``) in ``geo_deep_learning_tpu/ops/fused_upconv.py`` for
NCHW tensors and torch conv weights ``[Cout, Cin, 3, 3]``. With ``U`` the
resized input (zero outside) and ``A_h[k]``, ``A_w[l]`` the resize's row
matrices shifted by the tap offsets::

    Y[p, q] = sum_{k,l} K[k,l] U[p+k-1, q+l-1]
            = sum_{k,l,m,n} A_h[k][p,m] A_w[l][q,n] (x K[k,l])[m,n]

so the only ``Cin x Cout`` work is the channel GEMM ``x @ K`` at the SOURCE
resolution, and two thin products with the shifted interpolation matrices
finish the job; the resized map never exists. The plain composition is
:func:`reference` (resize, then ``F.conv2d``).

The products run on the channels-last (NHWC) layout that the port's models
use on the card, and every operand is a view (the shared matrix broadcast
with batch stride 0). The channel GEMM ``X [(b, h, w), Cin] @ K [Cin, (l,
k, d)]`` writes ``u`` as ``[B, H, W, 3 (l), 3 (k), Cout]``, so that ``(w,
l)`` is one contraction axis of stride ``3 Cout``; three products (one per
row tap ``k``) contract it into ``v [B, H, 3 (k), OW, Cout]``, so that
``(h, k)`` is one axis of stride ``OW Cout``; the last product writes
``[B, OH, OW, Cout]``, the output in the channels-last memory format that
the next BatchNorm and convolutions read (a contiguous NCHW output made
them copy it). The source is zero-padded to multiples of 8 rows and
columns, so that every operand's rows are 16-byte aligned. The backward
(:class:`_Factored`) runs the transposed products, each gradient landing in
its forward tensor's layout, and keeps only the input and the weight:
nothing of the output's size is permuted or copied either way. The
interpolation matrices are built once per (sizes, align_corners, device,
dtype) and kept on the device, outside inference mode (an evaluation may
build them before training uses them); they are not module state, so
``state_dict()`` is unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from geo_deep_learning_tpu_torch.ops.resize import resize


def interp_rows(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """``[out, in]`` row matrix of torch's bilinear resize (f64): half-pixel
    or corner-aligned source coordinates, indices clamped at the borders."""
    m = np.zeros((out_size, in_size), np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for f in range(out_size):
        if align_corners:
            src = f * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (f + 0.5) * in_size / out_size - 0.5
        i = int(np.floor(src))
        t = src - i
        m[f, min(max(i, 0), in_size - 1)] += 1.0 - t
        m[f, min(max(i + 1, 0), in_size - 1)] += t
    return m


def shifted_interp(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """``[3, out, in]`` with ``A[k][p, m] = W[p+k-1, m]`` (rows outside
    ``[0, out)`` zero): tap ``k`` of the conv reads resized row ``p+k-1``."""
    w = interp_rows(out_size, in_size, align_corners)
    a = np.zeros((3, out_size, in_size), np.float64)
    for k in range(3):
        lo, hi = max(0, 1 - k), min(out_size, out_size + 1 - k)
        a[k, lo:hi] = w[lo + k - 1 : hi + k - 1]
    return a


@functools.lru_cache(maxsize=64)
def _tap_matrix(
    out_size: int, in_size: int, align_corners: bool, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    """``[out, 3 * in_pad]`` on ``device``, ``in_pad`` the source size
    rounded up to a multiple of 8: row ``p``, column ``(m, k)`` holds
    ``A[k][p, m]``, zero for the padding rows ``m >= in_size``."""
    a = shifted_interp(out_size, in_size, align_corners).transpose(1, 2, 0)
    cols = 3 * in_size
    with torch.inference_mode(False):
        t = torch.zeros((out_size, 3 * _padded(in_size)), dtype=dtype, device=device)
        t[:, :cols] = torch.from_numpy(a.reshape(out_size, cols)).to(device=device, dtype=dtype)
    return t


def _padded(size: int) -> int:
    return -(-size // 8) * 8


class _Factored(torch.autograd.Function):
    """``y [B, OH, OW, Cout] (+ bias)`` from ``x [B, H, W, Cin]`` (contiguous)
    and ``kmat [Cin, (l, k, d)]`` through the tap matrices ``ah [p, (h, k)]``
    and ``aw [q, (w, l)]``."""

    @staticmethod
    def forward(ctx, x, kmat, bias, ah, aw):
        b, h, w, cin = x.shape
        cout, oh, ow = kmat.shape[1] // 9, ah.shape[0], aw.shape[0]
        u = (x.view(-1, cin) @ kmat).view(b * h, 3 * w, 3, cout)  # [(b, h), (w, l), k, d]
        v = x.new_empty((b * h, 3, ow, cout))  # [(b, h), k, q, d]
        for k in range(3):
            torch.bmm(aw.expand(b * h, -1, -1), u[:, :, k], out=v[:, k])
        y = torch.bmm(ah.expand(b, -1, -1), v.view(b, 3 * h, ow * cout))  # [b, p, (q, d)]
        if bias is not None:
            y.view(-1, cout).add_(bias.to(y.dtype))
        ctx.save_for_backward(x, kmat, ah, aw)
        ctx.has_bias = bias is not None
        return y.view(b, oh, ow, cout)

    @staticmethod
    def backward(ctx, gy):
        x, kmat, ah, aw = ctx.saved_tensors
        b, h, w, cin = x.shape
        _, oh, ow, cout = gy.shape
        gy = gy.to(x.dtype).contiguous()
        gv = torch.bmm(ah.mT.expand(b, -1, -1), gy.view(b, oh, ow * cout))  # v's layout
        gv = gv.view(b * h, 3, ow, cout)
        gu = x.new_empty((b * h, 3 * w, 3, cout))  # u's layout
        for k in range(3):
            torch.bmm(aw.mT.expand(b * h, -1, -1), gv[:, k], out=gu[:, :, k])
        gu = gu.view(-1, 9 * cout)
        gx = gk = gb = None
        if ctx.needs_input_grad[0]:
            gx = (gu @ kmat.mT).view(b, h, w, cin)
        if ctx.needs_input_grad[1]:
            gk = x.view(-1, cin).mT @ gu
        if ctx.has_bias and ctx.needs_input_grad[2]:
            acc = torch.promote_types(gy.dtype, torch.float32)
            gb = gy.view(-1, cout).sum(0, dtype=acc)
        return gx, gk, gb, None, None


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def resize_conv3x3_factored(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_hw: tuple[int, int] | None = None,
    align_corners: bool = False,
) -> torch.Tensor:
    """``conv3x3(resize(x, out_hw), weight, padding=1) + bias``, exactly up
    to summation order, as a channel GEMM at the source resolution and two
    thin products with the shifted interpolation matrices.

    Args:
        x: ``[B, Cin, H, W]`` source-resolution input (any memory format).
        weight: ``[Cout, Cin, 3, 3]`` conv weight.
        bias: optional ``[Cout]``.
        out_hw: resized size ``(OH, OW)``; None means ``(H, W)``, a plain 3x3 conv.
        align_corners: the resize's coordinate convention.

    Returns:
        ``[B, Cout, OH, OW]`` in the channels-last memory format.
    """
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    oh, ow = (h, w) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
    dtype = _compute_dtype(x)
    ah = _tap_matrix(oh, h, align_corners, x.device, dtype)  # [p, (h, k)]
    aw = _tap_matrix(ow, w, align_corners, x.device, dtype)  # [q, (w, l)]
    # columns (l, k, d) of the channel GEMM, so that u is [b, h, w, l, k, d]
    kmat = weight.to(dtype).permute(1, 3, 2, 0).reshape(cin, 9 * cout)
    # NHWC input: a view for channels-last x, the one relayout (at the source
    # resolution) otherwise; zero rows and columns up to multiples of 8 keep
    # every GEMM operand's rows 16-byte aligned (cuBLAS otherwise falls back
    # to unvectorized kernels), and the taps weight them 0
    x = x.to(dtype).permute(0, 2, 3, 1)
    if (_padded(h), _padded(w)) != (h, w):
        x = F.pad(x, (0, 0, 0, _padded(w) - w, 0, _padded(h) - h))
    return _Factored.apply(x.contiguous(), kmat, bias, ah, aw).permute(0, 3, 1, 2)

def reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    out_hw: tuple[int, int] | None = None,
    align_corners: bool = False,
) -> torch.Tensor:
    """The plain composition that :func:`resize_conv3x3_factored` factors."""
    if out_hw is not None:
        x = resize(x, size=out_hw, align_corners=align_corners)
    return F.conv2d(x, weight, bias, padding=1)
