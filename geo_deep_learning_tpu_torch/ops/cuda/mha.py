"""Packed multi-head attention forward (kernel K4).

Port of the forward half of the packed path of
``geo_deep_learning_tpu/ops/pallas/mha.py``: the input is the QKV
projection's natural output ``[B, L, 3*H*hd]`` with columns
``q heads | k heads | v heads``; the output is ``[B, L, H*hd]`` in the same
head packing plus the per-(head, row) logsumexp ``[B, H, L]`` f32.

Numerics of the TPU kernel: products of the input dtype accumulated in
f32, softmax in f32, the unnormalized probabilities cast to the input dtype
before the PV product, and the output divided by the f32 row sum. The CUDA
kernel (``csrc/attention.cu``) takes bfloat16; :func:`attention_reference`
is its plain PyTorch version, used for CPU tensors and as its expected value.
"""

from __future__ import annotations

import math

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "attention_fwd_packed"
HEAD_DIMS = (32, 64, 128)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    q, k, v = (
        t.reshape(b, l, num_heads, hd).transpose(1, 2) for t in qkv.split(d, dim=-1)
    )
    return q, k, v


def attention_reference(qkv: torch.Tensor, num_heads: int, scale: float):
    """Plain version: ``(o [B, L, H*hd], lse [B, H, L])``."""
    b, l, d3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    o = o.transpose(1, 2).reshape(b, l, d3 // 3).to(qkv.dtype)
    return o, lse


def _launch(qkv: torch.Tensor, num_heads: int, scale: float):
    _lib.require_cuda(qkv, KERNEL)
    if qkv.dtype != torch.bfloat16 or qkv.ndim != 3:
        msg = f"{KERNEL}: expected [B, L, 3D] bfloat16, got {qkv.dtype} {tuple(qkv.shape)}"
        raise ValueError(msg)
    b, l, d3 = qkv.shape
    if d3 % (3 * num_heads):
        msg = f"{KERNEL}: width {d3} is not 3 x {num_heads} heads"
        raise ValueError(msg)
    d = d3 // 3
    hd = d // num_heads
    if hd not in HEAD_DIMS:
        msg = f"{KERNEL}: head dim {hd} not in {HEAD_DIMS}"
        raise ValueError(msg)
    _lib.require_aligned(qkv, KERNEL)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, l), dtype=torch.float32, device=qkv.device)
    code = _lib.library().gdl_attention_fwd_packed(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, l, num_heads, hd,
        float(scale), _lib.stream_ptr(qkv),
    )
    _lib.check(code, KERNEL)
    return out, lse


def attention_packed(qkv: torch.Tensor, num_heads: int, scale: float | None = None):
    """Softmax attention over packed QKV -> ``(o, lse)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // num_heads)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, num_heads, scale)
    return _launch(qkv, num_heads, scale)
