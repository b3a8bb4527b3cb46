"""Multi-head attention: the packed pair (kernels K4/K7), the head-major pair
(K8/K9) and the dispatch between them.

Port of ``geo_deep_learning_tpu/ops/pallas/mha.py``. The packed input is the
QKV projection's natural output ``[B, L, 3*H*hd]`` with columns
``q heads | k heads | v heads``; its output is ``[B, L, H*hd]`` in the same
head packing. The head-major pair takes ``q, k, v`` as ``[B, H, L, hd]``
views of any batch, head and row strides and returns ``o`` in that shape;
:func:`attention` hands it the head slices of the packed tensors, so it
reads and writes them in place. Both return the per-(head, row) logsumexp
``[B, H, L]`` f32.

Numerics of the TPU kernels, shared by both pairs: products of the input
dtype accumulated in f32, softmax in f32, the unnormalized probabilities
cast to the input dtype before the PV product, and the output divided by
the f32 row sum. The backward recomputes ``p = exp(s - lse)``, takes
``delta = rowsum(g * o)``, casts ``p`` and ``ds = p * (g v^T - delta)`` to
the input dtype before their products, and scales ``dq`` and ``dk`` after
theirs. The CUDA kernels (``csrc/attention*.cu``; the forward's device
code in ``csrc/attention_kernels.cuh``, the backward's in
``csrc/attention_bwd_kernels.cuh``, both on wgmma with TMA-fed rings) take
bfloat16 and a positive scale; their float32 instances
(``csrc/attention_f32.cu``: the forward on f32 FMAs, the backward's
products as 3xTF32 on wgmma, ``csrc/attention_bwd_tf32.cuh``, both at f32
accuracy), which a ``32-true`` run takes, serve both layouts, counted under
their own names (``*_f32``). The ``*_reference`` functions are their plain
PyTorch versions, used for CPU tensors and as the kernels' expected values.
:class:`AttentionPackedFn` and :class:`AttentionHeadMajorFn` bind each pair
into autograd, saving what the JAX package's ``custom_vjp`` saves.

:func:`attention` takes the route the JAX package's
``fused_attention_packed`` takes on one TPU (:func:`route`): the packed
kernels where the TPU's packed kernels fit their VMEM budget, the
head-major kernels where they do not but the head-major kernel's budget
holds (for DOFA's head dim 64: padded token counts 1593-2304, a 558-669 px
input), and, past that, the packed kernels again, where the JAX package
falls back to XLA's einsum: K4 streams K/V and takes any L, while a plain
composition would hold ``[B, H, L, L]``.
"""

from __future__ import annotations

import math

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "attention_fwd_packed"
KERNEL_BWD = "attention_bwd_packed"
KERNEL_HM = "attention_fwd_hm"
KERNEL_HM_BWD = "attention_bwd_hm"
KERNEL_F32 = "attention_fwd_f32"
KERNEL_BWD_F32 = "attention_bwd_f32"
KERNEL_HM_F32 = "attention_fwd_hm_f32"
KERNEL_HM_BWD_F32 = "attention_bwd_hm_f32"
DTYPES = (torch.bfloat16, torch.float32)
HEAD_DIMS = (32, 64, 128)

# the JAX kernels' query tile, which is also the head-major path's padding
# unit, and the VMEM budgets of its shape rules (mha.py:476-481, :540-551)
_TQ = 256
_PACKED_VMEM = 14 * 1024 * 1024
_HEAD_MAJOR_VMEM = 12 * 1024 * 1024


def _pad_len(n: int) -> int:
    return -(-n // _TQ) * _TQ


def packed_supported(num_heads: int, l: int, hd: int) -> bool:
    """``_packed_supported`` (JAX ``mha.py:471-493``) without its mesh and
    platform clauses: the packed kernels take blocks of ``128 // hd`` heads
    and must fit their backward in the VMEM budget."""
    pair = max(1, 128 // hd)
    if 128 % hd or num_heads % pair:
        return False
    blk = l * pair * hd
    return 2 * (6 * 2 + 2 * 4) * blk + 4 * 4 * _TQ * l <= _PACKED_VMEM


def head_major_supported(l: int, hd: int) -> bool:
    """``_supported`` (JAX ``mha.py:534-553``) for self-attention over ``l``
    tokens, without its platform clause."""
    if hd % 8 or hd > 128:
        return False
    lq_pad, lk_pad = _pad_len(l), max(_pad_len(l), 8)
    vmem = (2 * 2 + 2 * 4) * lk_pad * hd + 4 * 2 * lq_pad * hd + 4 * 4 * _TQ * lk_pad
    return vmem <= _HEAD_MAJOR_VMEM


def route(num_heads: int, l: int, hd: int) -> str:
    """``"packed"`` (K4/K7) or ``"head_major"`` (K8/K9) for a shape."""
    if not packed_supported(num_heads, l, hd) and head_major_supported(l, hd):
        return "head_major"
    return "packed"


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, L, H*hd]`` -> a ``[B, H, L, hd]`` view."""
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    return tuple(_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = t.shape
    return t.transpose(1, 2).reshape(b, l, h * hd)


def _scores(q, k, scale: float, valid: int | None):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if valid is not None and valid < k.shape[-2]:
        s = s.masked_fill(torch.arange(k.shape[-2], device=s.device) >= valid, -math.inf)
    return s


def attention_hm_reference(q, k, v, scale: float, valid: int | None = None):
    """Plain version of K8: ``(o [B, H, L, hd], lse [B, H, L])``; key
    columns at or past ``valid`` (all of them count when None) count for
    nothing."""
    acc = _lib.acc_dtype(q.dtype)
    s = _scores(q.to(acc), k.to(acc), scale, valid)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).to(acc), v.to(acc)) / denom
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def attention_hm_bwd_reference(q, k, v, o, g, lse, scale: float, valid: int | None = None):
    """Plain version of K9: ``(dq, dk, dv)``, each ``[B, H, L, hd]``."""
    dt, acc = q.dtype, _lib.acc_dtype(q.dtype)
    q, k, v, o, g = (t.to(acc) for t in (q, k, v, o, g))
    p = torch.exp(_scores(q, k, scale, valid) - lse[..., None])
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    delta = (g * o).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).to(acc)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_reference(qkv: torch.Tensor, num_heads: int, scale: float):
    """Plain version of K4: ``(o [B, L, H*hd], lse [B, H, L])``."""
    o, lse = attention_hm_reference(*_split_heads(qkv, num_heads), scale)
    return _merge_heads(o), lse


def attention_bwd_reference(qkv, o, g, lse, num_heads: int, scale: float):
    """Plain version of K7: ``dqkv [B, L, 3*H*hd]`` in the packing order."""
    grads = attention_hm_bwd_reference(*_split_heads(qkv, num_heads), _heads(o, num_heads),
                                       _heads(g, num_heads), lse, scale)
    return torch.cat([_merge_heads(t) for t in grads], dim=-1)


def _check(qkv: torch.Tensor, num_heads: int, what: str) -> int:
    """Validate a packed bf16 or f32 ``[B, L, 3D]`` tensor; return the head dim."""
    _lib.require_cuda(qkv, what)
    if qkv.dtype not in DTYPES or qkv.ndim != 3:
        msg = f"{what}: expected [B, L, 3D] bfloat16 or float32, got {qkv.dtype} {tuple(qkv.shape)}"
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


def _check_hm(group, others, what: str) -> tuple[int, int, int, int]:
    """Validate head-major bf16 or f32 ``[B, H, L, hd]`` views of one shape
    and dtype, the tensors of ``group`` with one set of strides (the kernels
    take one layout for q, k, v and their gradients); return that shape."""
    first = group[0]
    _lib.require_cuda(first, what)
    if first.dtype not in DTYPES or first.ndim != 4:
        msg = (f"{what}: expected [B, H, L, hd] bfloat16 or float32, "
               f"got {first.dtype} {tuple(first.shape)}")
        raise ValueError(msg)
    for t in (*group, *others):
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            msg = f"{what}: every operand must be {tuple(first.shape)} {first.dtype}"
            raise ValueError(msg)
        _lib.require_rows_aligned(t, what)
    if any(t.stride() != first.stride() for t in group):
        msg = f"{what}: q, k, v and their gradients must share their strides"
        raise ValueError(msg)
    if first.shape[-1] not in HEAD_DIMS:
        msg = f"{what}: head dim {first.shape[-1]} not in {HEAD_DIMS}"
        raise ValueError(msg)
    return tuple(first.shape)


def _layout(t: torch.Tensor) -> tuple[int, int, int]:
    """The batch, head and row strides of a ``[B, H, L, hd]`` view."""
    return t.stride()[:3]


def _check_lse(lse: torch.Tensor, b: int, h: int, l: int, what: str) -> torch.Tensor:
    if lse.shape != (b, h, l) or lse.dtype != torch.float32:
        msg = f"{what}: lse must be [{b}, {h}, {l}] float32"
        raise ValueError(msg)
    return lse.contiguous()


def _launch(qkv: torch.Tensor, num_heads: int, scale: float):
    f32 = qkv.dtype == torch.float32
    hd = _check(qkv, num_heads, KERNEL_F32 if f32 else KERNEL)
    b, l, d3 = qkv.shape
    out = torch.empty((b, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if f32:
        return out, _fwd_f32(*_split_heads(qkv, num_heads), _heads(out, num_heads), scale,
                             KERNEL_F32)
    lse = torch.empty((b, num_heads, l), dtype=torch.float32, device=qkv.device)
    code = _lib.library().gdl_attention_fwd_packed(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, l, num_heads, hd,
        float(scale), _lib.stream_ptr(qkv),
    )
    _lib.check(code, KERNEL)
    return out, lse


def _fwd_f32(q, k, v, out, scale: float, kernel: str) -> torch.Tensor:
    """The f32 forward over checked ``[B, H, L, hd]`` views, ``o`` into
    ``out``; returns lse."""
    b, h, l, hd = q.shape
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    code = _lib.library().gdl_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(out), float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, kernel)
    return lse


def _bwd_f32(q, k, v, o, g, lse, scale: float, out, kernel: str) -> None:
    """The f32 backward over checked views, ``(dq, dk, dv)`` into ``out``."""
    b, h, l, hd = q.shape
    delta = torch.empty_like(lse)
    dq, dk, dv = out
    code = _lib.library().gdl_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(o), *_layout(g), float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, kernel)


def attention_packed(qkv: torch.Tensor, num_heads: int, scale: float | None = None):
    """Softmax attention over packed QKV -> ``(o, lse)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // num_heads)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, num_heads, scale)
    return _launch(qkv, num_heads, scale)


def _launch_bwd(qkv, o, g, lse, num_heads: int, scale: float):
    f32 = qkv.dtype == torch.float32
    what = KERNEL_BWD_F32 if f32 else KERNEL_BWD
    hd = _check(qkv, num_heads, what)
    b, l, d3 = qkv.shape
    for t in (o, g):
        if t.shape != (b, l, d3 // 3) or t.dtype != qkv.dtype:
            msg = f"{what}: o and g must be [{b}, {l}, {d3 // 3}] {qkv.dtype}"
            raise ValueError(msg)
        _lib.require_aligned(t, what)
    lse = _check_lse(lse, b, num_heads, l, what)
    dqkv = torch.empty_like(qkv)
    if f32:
        h = num_heads
        _bwd_f32(*_split_heads(qkv, h), _heads(o, h), _heads(g, h), lse, scale,
                 _split_heads(dqkv, h), KERNEL_BWD_F32)
        return dqkv
    delta = torch.empty_like(lse)
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


def _launch_hm(q, k, v, scale: float, out):
    out = torch.empty_like(q, memory_format=torch.contiguous_format) if out is None else out
    f32 = q.dtype == torch.float32
    b, h, l, hd = _check_hm((q, k, v), (out,), KERNEL_HM_F32 if f32 else KERNEL_HM)
    if f32:
        return out, _fwd_f32(q, k, v, out, scale, KERNEL_HM_F32)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    code = _lib.library().gdl_attention_fwd_hm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(out), float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, KERNEL_HM)
    return out, lse


def attention_hm(q, k, v, scale: float | None = None, out=None):
    """Softmax attention over head-major ``[B, H, L, hd]`` q, k, v ->
    ``(o, lse)``; ``o`` is written into ``out`` where one is given (a view
    of the same shape)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        o, lse = attention_hm_reference(q, k, v, scale)
        return (o, lse) if out is None else (out.copy_(o), lse)
    return _launch_hm(q, k, v, scale, out)


def _launch_hm_bwd(q, k, v, o, g, lse, scale: float, out):
    if out is None:
        out = tuple(torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device)
                    for _ in range(3))
    f32 = q.dtype == torch.float32
    what = KERNEL_HM_BWD_F32 if f32 else KERNEL_HM_BWD
    b, h, l, hd = _check_hm((q, k, v, *out), (o, g), what)
    lse = _check_lse(lse, b, h, l, what)
    if f32:
        _bwd_f32(q, k, v, o, g, lse, scale, out, KERNEL_HM_BWD_F32)
        return out
    delta = torch.empty_like(lse)
    dq, dk, dv = out
    code = _lib.library().gdl_attention_bwd_hm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(o), *_layout(g), float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, KERNEL_HM_BWD)
    return out


def attention_hm_bwd(q, k, v, o, g, lse, scale: float, out=None):
    """Backward of :func:`attention_hm` -> ``(dq, dk, dv)``, written into the
    three views of ``out`` (with q's strides) where given."""
    if q.device.type == "cpu":
        grads = attention_hm_bwd_reference(q, k, v, o, g, lse, scale)
        return grads if out is None else tuple(d.copy_(t) for d, t in zip(out, grads))
    return _launch_hm_bwd(q, k, v, o, g, lse, scale, out)


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


class AttentionHeadMajorFn(torch.autograd.Function):
    """``o = attention(qkv)`` through K8, backward through K9, on the head
    slices of the packed tensors, read and written in place: ``o`` is
    ``[B, L, H*hd]`` and the gradient ``dqkv`` is in the packing order, as
    for :class:`AttentionPackedFn`. Saves ``(q, k, v, o, lse)`` as the JAX
    package's ``_attention_fwd`` does, ``q, k, v`` as views of ``qkv``."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        q, k, v = _split_heads(qkv, num_heads)
        o = qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3))
        _, lse = attention_hm(q, k, v, scale, out=_heads(o, num_heads))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        h = ctx.num_heads
        g = g.to(o.dtype).contiguous()
        b, l, d = o.shape
        dqkv = o.new_empty((b, l, 3 * d))
        attention_hm_bwd(q, k, v, _heads(o, h), _heads(g, h), lse, ctx.scale,
                         out=_split_heads(dqkv, h))
        return dqkv, None, None


def attention(qkv: torch.Tensor, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention over packed QKV -> ``o [B, L, H*hd]``,
    through the pair that :func:`route` picks."""
    hd = qkv.shape[-1] // 3 // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    fn = AttentionPackedFn if route(num_heads, qkv.shape[1], hd) == "packed" else AttentionHeadMajorFn
    return fn.apply(qkv, num_heads, scale)
