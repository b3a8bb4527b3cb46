"""Packed multi-head attention, forward (kernel K4) and backward (kernel K7).

Port of the packed path of ``geo_deep_learning_tpu/ops/pallas/mha.py``:
the input is the QKV
projection's natural output ``[B, L, 3*H*hd]`` with columns
``q heads | k heads | v heads``; the output is ``[B, L, H*hd]`` in the same
head packing plus the per-(head, row) logsumexp ``[B, H, L]`` f32.

Numerics of the TPU kernel: products of the input dtype accumulated in
f32, softmax in f32, the unnormalized probabilities cast to the input dtype
before the PV product, and the output divided by the f32 row sum. The
backward recomputes ``p = exp(s - lse)``, takes ``delta = rowsum(g * o)``,
casts ``p`` and ``ds = p * (g v^T - delta)`` to the input dtype before their
products, scales ``dq`` and ``dk`` after theirs, and returns ``dqkv`` in the
packing order. The CUDA kernels (``csrc/attention.cu``,
``csrc/attention_bwd.cu``) take bfloat16; :func:`attention_reference` and
:func:`attention_bwd_reference` are their plain PyTorch versions, used for
CPU tensors and as the kernels' expected values. :class:`AttentionPackedFn`
binds the pair into autograd, saving ``(qkv, o, lse)`` as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

import math

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "attention_fwd_packed"
KERNEL_BWD = "attention_bwd_packed"
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
    acc = _lib.acc_dtype(qkv.dtype)
    q, k, v = (t.to(acc) for t in _split_heads(qkv, num_heads))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).to(acc), v) / denom
    lse = (m + torch.log(denom))[..., 0]
    o = o.transpose(1, 2).reshape(b, l, d3 // 3).to(qkv.dtype)
    return o, lse


def _check(qkv: torch.Tensor, num_heads: int, what: str) -> int:
    """Validate a packed bf16 ``[B, L, 3D]`` tensor; return the head dim."""
    _lib.require_cuda(qkv, what)
    if qkv.dtype != torch.bfloat16 or qkv.ndim != 3:
        msg = f"{what}: expected [B, L, 3D] bfloat16, got {qkv.dtype} {tuple(qkv.shape)}"
        raise ValueError(msg)
    d3 = qkv.shape[-1]
    if d3 % (3 * num_heads):
        msg = f"{what}: width {d3} is not 3 x {num_heads} heads"
        raise ValueError(msg)
    hd = d3 // 3 // num_heads
    if hd not in HEAD_DIMS:
        msg = f"{what}: head dim {hd} not in {HEAD_DIMS}"
        raise ValueError(msg)
    _lib.require_aligned(qkv, what)
    return hd


def _launch(qkv: torch.Tensor, num_heads: int, scale: float):
    hd = _check(qkv, num_heads, KERNEL)
    b, l, d3 = qkv.shape
    d = d3 // 3
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


def attention_bwd_reference(qkv, o, g, lse, num_heads: int, scale: float):
    """Plain version of K7: ``dqkv [B, L, 3*H*hd]`` in the packing order."""
    b, l, d3 = qkv.shape
    dt, acc = qkv.dtype, _lib.acc_dtype(qkv.dtype)
    q, k, v = (t.to(acc) for t in _split_heads(qkv, num_heads))
    gh, oh = (t.reshape(b, l, num_heads, -1).transpose(1, 2).to(acc) for t in (g, o))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).to(acc)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return torch.cat(
        [t.transpose(1, 2).reshape(b, l, d3 // 3) for t in (dq, dk, dv)], dim=-1
    ).to(dt)


def _launch_bwd(qkv, o, g, lse, num_heads: int, scale: float):
    hd = _check(qkv, num_heads, KERNEL_BWD)
    b, l, d3 = qkv.shape
    for t in (o, g):
        if t.shape != (b, l, d3 // 3) or t.dtype != qkv.dtype:
            msg = f"{KERNEL_BWD}: o and g must be [{b}, {l}, {d3 // 3}] {qkv.dtype}"
            raise ValueError(msg)
        _lib.require_aligned(t, KERNEL_BWD)
    if lse.shape != (b, num_heads, l) or lse.dtype != torch.float32:
        msg = f"{KERNEL_BWD}: lse must be [{b}, {num_heads}, {l}] float32"
        raise ValueError(msg)
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    dqkv = torch.empty_like(qkv)
    code = _lib.library().gdl_attention_bwd_packed(
        qkv.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, l, num_heads, hd, float(scale), _lib.stream_ptr(qkv),
    )
    _lib.check(code, KERNEL_BWD)
    return dqkv


def attention_bwd_packed(qkv, o, g, lse, num_heads: int, scale: float):
    """Backward of :func:`attention_packed` -> ``dqkv``."""
    if qkv.device.type == "cpu":
        return attention_bwd_reference(qkv, o, g, lse, num_heads, scale)
    return _launch_bwd(qkv, o, g, lse, num_heads, scale)


class AttentionPackedFn(torch.autograd.Function):
    """``o = attention(qkv)`` through K4, backward through K7; saves
    ``(qkv, o, lse)``."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        o, lse = attention_packed(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, o, lse = ctx.saved_tensors
        g = g.to(o.dtype).contiguous()
        return attention_bwd_packed(qkv, o, g, lse, ctx.num_heads, ctx.scale), None, None


def attention(qkv: torch.Tensor, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention over packed QKV -> ``o``."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // num_heads)
    return AttentionPackedFn.apply(qkv, num_heads, scale)
