"""Multi-head attention: the packed pair (kernels K4/K7), the head-major pair
(K8/K9) and the dispatch between them.

Port of ``geo_deep_learning_tpu/ops/pallas/mha.py``. The packed input is the
QKV projection's natural output ``[B, L, 3*H*hd]`` with columns
``q heads | k heads | v heads``; its output is ``[B, L, H*hd]`` in the same
head packing. Both pairs take and return these packed tensors: the
head-major kernels read ``q, k, v`` and write ``o`` (and, backward,
``dq, dk, dv``) through ``[B, H, L, hd]`` views of the head slices, in
place, so the route copies and merges nothing. Both return the
per-(head, row) logsumexp ``[B, H, L]`` f32.

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
(``csrc/attention_f32.cu``: the products of the forward and the backward
as 3xTF32 on wgmma, ``csrc/attention_fwd_tf32.cuh`` and
``csrc/attention_bwd_tf32.cuh``, both at f32 accuracy), which a ``32-true`` run takes, serve both layouts, counted under
their own names (``*_f32``). The ``*_reference`` functions are their plain
PyTorch versions, used for CPU tensors and as the kernels' expected values.
Each kernel is a ``gdl::`` operator under its kernel's name (the f32
instances under the same operators, by dtype); each forward's registered
backward is its pair's backward operator, saving what the JAX package's
``custom_vjp`` saves, ``(qkv, o, lse)``.

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
    """Validate a packed bf16 or f32 ``[B, L, 3D]`` tensor's type and shape
    (the same for the kernels and for a trace); return the head dim."""
    if qkv.dtype not in DTYPES or qkv.ndim != 3:
        msg = f"{what}: expected [B, L, 3D] bfloat16 or float32, got {qkv.dtype} {tuple(qkv.shape)}"
        raise ValueError(msg)
    d3 = qkv.shape[-1]
    if d3 % (3 * num_heads):
        msg = f"{what}: width {d3} is not 3 x {num_heads} heads"
        raise ValueError(msg)
    return d3 // 3 // num_heads


def _check_kernel(qkv: torch.Tensor, num_heads: int, what: str) -> int:
    """:func:`_check` and the kernels' own head dims (the plain versions
    take any); return the head dim."""
    hd = _check(qkv, num_heads, what)
    if hd not in HEAD_DIMS:
        msg = f"{what}: head dim {hd} not in {HEAD_DIMS}"
        raise ValueError(msg)
    return hd


def _check_grads(qkv, o, g, lse, num_heads: int, what: str) -> None:
    """The backward's other operands against a checked ``qkv``."""
    b, l, d3 = qkv.shape
    for t in (o, g):
        if t.shape != (b, l, d3 // 3) or t.dtype != qkv.dtype:
            msg = f"{what}: o and g must be [{b}, {l}, {d3 // 3}] {qkv.dtype}"
            raise ValueError(msg)
    if lse.shape != (b, num_heads, l) or lse.dtype != torch.float32:
        msg = f"{what}: lse must be [{b}, {num_heads}, {l}] float32"
        raise ValueError(msg)


def _layout(t: torch.Tensor) -> tuple[int, int, int]:
    """The batch, head and row strides of a ``[B, H, L, hd]`` view."""
    return t.stride()[:3]


def _fwd_f32(q, k, v, out, scale: float, kernel: str) -> torch.Tensor:
    """The f32 forward over ``[B, H, L, hd]`` views, ``o`` into ``out``;
    returns lse."""
    b, h, l, hd = q.shape
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    code = _lib.library().gdl_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(out), float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, kernel)
    return lse


def _bwd_f32(q, k, v, o, g, lse, scale: float, out, kernel: str) -> None:
    """The f32 backward over ``[B, H, L, hd]`` views, ``(dq, dk, dv)`` into
    ``out``."""
    b, h, l, hd = q.shape
    delta = torch.empty_like(lse)
    dq, dk, dv = out
    code = _lib.library().gdl_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(o), *_layout(g), float(scale), _lib.stream_ptr(q),
    )
    _lib.check(code, kernel)


def _packed_fwd(qkv: torch.Tensor, num_heads: int, scale: float):
    """K4 (its f32 instance on f32) -> ``(o, lse)``."""
    f32 = qkv.dtype == torch.float32
    what = KERNEL_F32 if f32 else KERNEL
    hd = _check_kernel(qkv, num_heads, what)
    _lib.require_aligned(qkv, what)
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


def _packed_bwd(qkv, o, g, lse, num_heads: int, scale: float):
    """K7 (its f32 instance on f32) -> ``dqkv``."""
    f32 = qkv.dtype == torch.float32
    what = KERNEL_BWD_F32 if f32 else KERNEL_BWD
    hd = _check_kernel(qkv, num_heads, what)
    _check_grads(qkv, o, g, lse, num_heads, what)
    for t in (qkv, o, g):
        _lib.require_aligned(t, what)
    lse = lse.contiguous()
    b, l, _ = qkv.shape
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


def _hm_fwd(qkv: torch.Tensor, num_heads: int, scale: float):
    """K8 (its f32 instance on f32) on the head slices of the packed
    tensors, read and written in place -> ``(o [B, L, H*hd], lse)``."""
    f32 = qkv.dtype == torch.float32
    what = KERNEL_HM_F32 if f32 else KERNEL_HM
    hd = _check_kernel(qkv, num_heads, what)
    _lib.require_rows_aligned(qkv, what)
    b, l, d3 = qkv.shape
    out = torch.empty((b, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    q, k, v = _split_heads(qkv, num_heads)
    o = _heads(out, num_heads)
    if f32:
        return out, _fwd_f32(q, k, v, o, scale, KERNEL_HM_F32)
    lse = torch.empty((b, num_heads, l), dtype=torch.float32, device=qkv.device)
    code = _lib.library().gdl_attention_fwd_hm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, l, num_heads, hd, *_layout(q), *_layout(o), float(scale), _lib.stream_ptr(qkv),
    )
    _lib.check(code, KERNEL_HM)
    return out, lse


def _hm_bwd(qkv, o, g, lse, num_heads: int, scale: float):
    """K9 (its f32 instance on f32) -> ``dqkv`` in the packing order, each
    gradient written into its head slices."""
    f32 = qkv.dtype == torch.float32
    what = KERNEL_HM_BWD_F32 if f32 else KERNEL_HM_BWD
    _check_kernel(qkv, num_heads, what)
    _check_grads(qkv, o, g, lse, num_heads, what)
    for t in (qkv, o, g):
        _lib.require_rows_aligned(t, what)
    lse = lse.contiguous()
    h = num_heads
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    q, k, v = _split_heads(qkv, h)
    oh, gh = _heads(o, h), _heads(g, h)
    out = _split_heads(dqkv, h)
    if any(t.stride() != q.stride() for t in out):
        msg = f"{what}: q, k, v and their gradients must share their strides"
        raise ValueError(msg)
    if f32:
        _bwd_f32(q, k, v, oh, gh, lse, scale, out, KERNEL_HM_BWD_F32)
        return dqkv
    delta = torch.empty_like(lse)
    dq, dk, dv = out
    b, _, l, hd = q.shape
    code = _lib.library().gdl_attention_bwd_hm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), oh.data_ptr(), gh.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, l, h, hd, *_layout(q), *_layout(oh), *_layout(gh), float(scale), _lib.stream_ptr(qkv),
    )
    _lib.check(code, KERNEL_HM_BWD)
    return dqkv


def _fwd_fake(qkv, num_heads: int, scale: float):
    _check(qkv, num_heads, KERNEL)
    b, l, d3 = qkv.shape
    return qkv.new_empty((b, l, d3 // 3)), qkv.new_empty((b, num_heads, l), dtype=torch.float32)


def _bwd_fake(qkv, o, g, lse, num_heads: int, scale: float):
    _check(qkv, num_heads, KERNEL_BWD)
    _check_grads(qkv, o, g, lse, num_heads, KERNEL_BWD)
    return qkv.new_empty(qkv.shape)


_FWD_SCHEMA = "(Tensor qkv, int num_heads, float scale) -> (Tensor, Tensor)"
_BWD_SCHEMA = ("(Tensor qkv, Tensor o, Tensor g, Tensor lse, int num_heads, float scale)"
               " -> Tensor")
ATTENTION_FWD_PACKED = _lib.define(KERNEL + _FWD_SCHEMA, cpu=attention_reference,
                                   cuda=_packed_fwd, fake=_fwd_fake)
ATTENTION_BWD_PACKED = _lib.define(KERNEL_BWD + _BWD_SCHEMA, cpu=attention_bwd_reference,
                                   cuda=_packed_bwd, fake=_bwd_fake)
ATTENTION_FWD_HM = _lib.define(KERNEL_HM + _FWD_SCHEMA, cpu=attention_reference,
                               cuda=_hm_fwd, fake=_fwd_fake)
ATTENTION_BWD_HM = _lib.define(KERNEL_HM_BWD + _BWD_SCHEMA, cpu=attention_bwd_reference,
                               cuda=_hm_bwd, fake=_bwd_fake)


def _scale(qkv: torch.Tensor, num_heads: int, scale: float | None) -> float:
    return 1.0 / math.sqrt(qkv.shape[-1] // 3 // num_heads) if scale is None else scale


def attention_packed(qkv: torch.Tensor, num_heads: int, scale: float | None = None):
    """Softmax attention over packed QKV through K4 -> ``(o, lse)``."""
    _lib.require_device(qkv, KERNEL)
    return ATTENTION_FWD_PACKED(qkv, num_heads, _scale(qkv, num_heads, scale))


def attention_bwd_packed(qkv, o, g, lse, num_heads: int, scale: float):
    """Backward of :func:`attention_packed` through K7 -> ``dqkv``."""
    _lib.require_device(qkv, KERNEL_BWD)
    return ATTENTION_BWD_PACKED(qkv, o, g, lse, num_heads, scale)


def attention_hm(qkv: torch.Tensor, num_heads: int, scale: float | None = None):
    """Softmax attention over packed QKV through K8, on its head slices ->
    ``(o [B, L, H*hd], lse)``."""
    _lib.require_device(qkv, KERNEL_HM)
    return ATTENTION_FWD_HM(qkv, num_heads, _scale(qkv, num_heads, scale))


def attention_hm_bwd(qkv, o, g, lse, num_heads: int, scale: float):
    """Backward of :func:`attention_hm` through K9 -> ``dqkv`` in the
    packing order."""
    _lib.require_device(qkv, KERNEL_HM_BWD)
    return ATTENTION_BWD_HM(qkv, o, g, lse, num_heads, scale)


def _setup(ctx, inputs, output) -> None:
    """The JAX ``custom_vjp``'s residuals: ``(qkv, o, lse)``."""
    qkv, num_heads, scale = inputs
    o, lse = output
    ctx.save_for_backward(qkv, o, lse)
    ctx.num_heads, ctx.scale = num_heads, scale
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _backward(bwd):
    def backward(ctx, g, _dlse):
        qkv, o, lse = ctx.saved_tensors
        g = torch.zeros_like(o) if g is None else g.to(o.dtype).contiguous()
        return bwd(qkv, o, g, lse, ctx.num_heads, ctx.scale), None, None
    return backward


for _fwd, _bwd in ((ATTENTION_FWD_PACKED, ATTENTION_BWD_PACKED),
                   (ATTENTION_FWD_HM, ATTENTION_BWD_HM)):
    torch.library.register_autograd(_fwd, _backward(_bwd), setup_context=_setup,
                                    lib=_lib.LIBRARY)


def attention(qkv: torch.Tensor, num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention over packed QKV -> ``o [B, L, H*hd]``,
    through the pair that :func:`route` picks."""
    _lib.require_device(qkv, KERNEL)
    hd = qkv.shape[-1] // 3 // num_heads
    fwd = ATTENTION_FWD_PACKED if route(num_heads, qkv.shape[1], hd) == "packed" else ATTENTION_FWD_HM
    return fwd(qkv, num_heads, _scale(qkv, num_heads, scale))[0]
