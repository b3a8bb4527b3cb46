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
  ones; its registered backward saves ``(q, k, v)`` and recomputes the
  probabilities;
- the ``gdl::sr_attention_bwd`` operator is that backward on bf16 CUDA
  tensors: the kernel ``csrc/sr_attention_bwd.cu``, which replaces no TPU
  kernel (the JAX package's backward is einsums, ``_attention_bwd``). It
  replaces :func:`sr_attention_bwd`, that backward in f32 PyTorch math,
  whose five f32 matmuls on the FMA pipe and dozen f32 score-sized
  temporaries took ~38 ms of a bs-32 MiT-B2 train step on an H100. It is
  bound by operations (10 n D tensor flops for n scores); it computes at K10's
  forward arithmetic (bf16 operands on wgmma, p and ds never rounded to
  bf16 as a whole but split into bf16 hi + lo, the row statistics and
  Delta recomputed in f32) in three launches of one call: dQ with the row
  statistics, query-major; f32 dK/dV partials over ranges of Lq,
  key-major; their sum in range order, so equal run to run.
  :func:`sr_attention_bwd` stays the plain version, which f32 inputs
  (``32-true``) and CPU tensors take.

The kernels read q, k, v and g through their strides and write ``o``,
``dq``, ``dk`` and ``dv`` as ``[B, L, H, D]`` buffers viewed as ``[B, H,
L, D]``, so the projections' ``[B, L, H, D]`` outputs go in and come out
without a transpose.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "sr_attention_fwd"
KERNEL_BWD = "sr_attention_bwd"
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
    products, ``(dq, dk, dv)`` in their inputs' dtypes; the plain version
    of ``gdl::sr_attention_bwd``."""
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


def _check_bwd(q, k, v, g) -> None:
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        msg = f"{KERNEL_BWD}: g must match q, got {tuple(g.shape)} {g.dtype}"
        raise ValueError(msg)


def _grads(q, k):
    """``(dq, dk, dv)`` as the kernel writes them, in the forward's output
    layout."""
    return _output(q), _output(k), _output(k)


@functools.cache
def _workspace(index: int, b: int, h: int, lq: int, lk: int, d: int) -> int:
    """The f32 scratch floats of the backward at these sizes on CUDA device
    ``index``, as the library plans its grids there."""
    floats = ctypes.c_longlong()
    with torch.cuda.device(index):
        code = _lib.library().gdl_sr_attention_bwd_workspace(b, h, lq, lk, d,
                                                             ctypes.byref(floats))
    if code != 0:
        err = _lib.library().gdl_error_string(code).decode()
        msg = f"{KERNEL_BWD} at {(b, h, lq, lk, d)}: no workspace ({err}, {code})"
        raise RuntimeError(msg)
    return floats.value


def _launch_bwd(q, k, v, g, scale: float):
    _check_bwd(q, k, v, g)
    if q.dtype != torch.bfloat16:
        msg = f"{KERNEL_BWD}: the kernel takes bfloat16, got {q.dtype}"
        raise ValueError(msg)
    if q.shape[3] not in HEAD_DIMS:
        msg = f"{KERNEL_BWD}: head dim {q.shape[3]} not in {HEAD_DIMS}"
        raise ValueError(msg)
    for t in (q, k, v):
        _lib.require_rows_aligned(t, KERNEL_BWD)
    # autograd picks g's layout: one the kernel cannot read (an expanded
    # gradient, as o.sum() gives, has stride 0) is copied first
    if not _lib.rows_aligned(g) or 0 in g.stride():
        g = g.contiguous()
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq, dk, dv = _grads(q, k)
    work = torch.empty(_workspace(q.device.index, b, h, lq, lk, d), dtype=torch.float32,
                       device=q.device)
    strides = [s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]]
    code = _lib.library().gdl_sr_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), work.data_ptr(), b, h, lq, lk, d, *strides, float(scale),
        _lib.stream_ptr(q),
    )
    _lib.check(code, KERNEL_BWD)
    return dq, dk, dv


def _plain_bwd(q, k, v, g, scale: float):
    """The plain version in the kernel's output layout."""
    return tuple(out.copy_(x) for out, x in zip(_grads(q, k), sr_attention_bwd(q, k, v, g, scale)))


def _fake_bwd(q, k, v, g, scale: float):
    _check_bwd(q, k, v, g)
    return _grads(q, k)


SR_ATTENTION_BWD = _lib.define(
    f"{KERNEL_BWD}(Tensor q, Tensor k, Tensor v, Tensor g, float scale)"
    " -> (Tensor, Tensor, Tensor)",
    cpu=_plain_bwd, cuda=_launch_bwd, fake=_fake_bwd)


def _setup(ctx, inputs, output) -> None:
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.scale = scale


def _backward(ctx, g):
    """The kernel for bf16 CUDA tensors, the plain version for f32 and CPU
    ones."""
    q, k, v = ctx.saved_tensors
    if q.is_cuda and q.dtype == torch.bfloat16:
        return (*SR_ATTENTION_BWD(q, k, v, g, ctx.scale), None)
    return (*sr_attention_bwd(q, k, v, g, ctx.scale), None)


torch.library.register_autograd(SR_ATTENTION_FWD, _backward, setup_context=_setup,
                                lib=_lib.LIBRARY)


def sr_attention(q, k, v, scale: float) -> torch.Tensor:
    """Differentiable attention over ``[B, H, L, D]`` tensors: the kernel's
    operator where :func:`supported` holds, else the einsum."""
    if supported(q, k):
        return sr_attention_fwd(q, k, v, scale)
    return einsum_attention(q, k, v, scale)
