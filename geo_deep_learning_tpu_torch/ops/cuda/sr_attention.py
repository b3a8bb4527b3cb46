"""Spatial-reduction attention of the MiT encoder (kernel K10).

Port of ``geo_deep_learning_tpu/ops/pallas/sr_attention.py``: softmax
attention of ``[B, H, Lq, D]`` queries over a short ``[B, H, Lk, D]`` K/V
(the spatially reduced tokens), ``o = softmax(q k^T * scale) v``, with the
scores, the softmax and the PV product in f32 and ``o`` in the input dtype.

- :func:`sr_attention_plain` is the kernel's plain version: the TPU
  kernel's f32 arithmetic in PyTorch, used for CPU tensors and as the
  kernel's expected value;
- :func:`einsum_attention` is the JAX package's ``_einsum_attention``,
  taken where the kernel does not apply (its probabilities are cast to
  the input dtype before the PV product);
- :func:`supported` is the JAX ``_supported`` shape rule without its
  platform check, so the same layers take the same math on both;
- the ``gdl::sr_attention_fwd`` operator runs the CUDA kernel
  ``csrc/sr_attention.cu`` for CUDA tensors and the plain version for CPU
  ones; its registered backward is the JAX ``_attention_bwd`` in
  PyTorch (:func:`sr_attention_bwd`): it saves ``(q, k, v)`` and
  recomputes the probabilities with f32 products, so the backward
  launches no kernel, as in the JAX package.

The kernel reads q, k and v through their strides and writes ``o`` as a
``[B, Lq, H, D]`` buffer viewed as ``[B, H, Lq, D]``, so the projections'
``[B, L, H, D]`` outputs go in and come out without a transpose.
"""

from __future__ import annotations

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "sr_attention_fwd"
HEAD_DIMS = (32, 64)
TQ = 512  # the TPU kernel's query tile, which its shape rule is stated in
VMEM_BYTES = 8 * 1024 * 1024


def _no_autocast(t: torch.Tensor):
    return torch.autocast(device_type=t.device.type, enabled=False)


def supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's rule for taking the kernel: Lq a multiple of 512,
    Lk of 8, and the f32 K/V plus one 512-row score tile within 8 MiB."""
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    if lq % TQ != 0 or lq < TQ or lk % 8 != 0:
        return False
    return 4 * (2 * lk * d + TQ * lk + 2 * TQ * d) <= VMEM_BYTES


def sr_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K10: f32 scores, max-subtracted softmax normalized
    before the f32 PV product, output in q's dtype."""
    with _no_autocast(q):
        acc = _lib.acc_dtype(q.dtype)
        s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        return torch.matmul(p, v.to(acc)).to(q.dtype)


def einsum_attention(q, k, v, scale: float) -> torch.Tensor:
    """The JAX ``_einsum_attention``: f32 scores and softmax, probabilities
    cast to q's dtype, PV product in that dtype."""
    with _no_autocast(q):
        acc = _lib.acc_dtype(q.dtype)
        s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.matmul(p, v.to(q.dtype))


def _check(q, k, v) -> None:
    """Type and shape checks, the same for the kernel and for a trace (the
    kernel's head dims are its own: the plain version takes any)."""
    if q.dtype not in (torch.bfloat16, torch.float32) or not (q.dtype == k.dtype == v.dtype):
        msg = f"{KERNEL}: q, k, v must share bfloat16 or float32, got {q.dtype}, {k.dtype}, {v.dtype}"
        raise ValueError(msg)
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        msg = f"{KERNEL}: expected q [B,H,Lq,D], k/v [B,H,Lk,D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        raise ValueError(msg)


def _output(q: torch.Tensor) -> torch.Tensor:
    """``o`` as the kernel writes it: a ``[B, Lq, H, D]`` buffer viewed as
    ``[B, H, Lq, D]``."""
    b, h, lq, d = q.shape
    return q.new_empty((b, lq, h, d)).transpose(1, 2)


def _launch(q, k, v, scale: float) -> torch.Tensor:
    _check(q, k, v)
    if q.shape[3] not in HEAD_DIMS:
        msg = f"{KERNEL}: head dim {q.shape[3]} not in {HEAD_DIMS}"
        raise ValueError(msg)
    for t in (q, k, v):
        _lib.require_rows_aligned(t, KERNEL)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = _output(q)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    code = _lib.library().gdl_sr_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, lq, lk, d,
        int(q.dtype == torch.bfloat16), *strides, float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, KERNEL)
    return out


def _plain(q, k, v, scale: float) -> torch.Tensor:
    """The plain version in the kernel's output layout."""
    return _output(q).copy_(sr_attention_plain(q, k, v, scale))


def _fake(q, k, v, scale: float) -> torch.Tensor:
    _check(q, k, v)
    return _output(q)


SR_ATTENTION_FWD = _lib.define(
    f"{KERNEL}(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    cpu=_plain, cuda=_launch, fake=_fake)


def sr_attention_fwd(q, k, v, scale: float) -> torch.Tensor:
    """K10 for CUDA tensors, its plain version for CPU tensors."""
    _lib.require_device(q, KERNEL)
    return SR_ATTENTION_FWD(q, k, v, scale)


def sr_attention_bwd(q, k, v, g, scale: float):
    """The JAX ``_attention_bwd``: probabilities recomputed with f32
    products, ``(dq, dk, dv)`` in their inputs' dtypes."""
    with _no_autocast(q):
        acc = _lib.acc_dtype(q.dtype)
        qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
        p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _setup(ctx, inputs, output) -> None:
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.scale = scale


def _backward(ctx, g):
    q, k, v = ctx.saved_tensors
    return (*sr_attention_bwd(q, k, v, g, ctx.scale), None)


torch.library.register_autograd(SR_ATTENTION_FWD, _backward, setup_context=_setup,
                                lib=_lib.LIBRARY)


def sr_attention(q, k, v, scale: float) -> torch.Tensor:
    """Differentiable attention over ``[B, H, L, D]`` tensors: the kernel's
    operator where :func:`supported` holds, else the einsum."""
    if supported(q, k):
        return sr_attention_fwd(q, k, v, scale)
    return einsum_attention(q, k, v, scale)
