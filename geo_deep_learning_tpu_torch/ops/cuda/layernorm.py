"""LayerNorm, plain (kernels K2/K5) and residual-fused (kernels K3/K6).

Port of ``geo_deep_learning_tpu/ops/pallas/layernorm.py`` for ``[B, L, D]``
token streams. Forward: f32 statistics with the fast variance
``max(E[x^2] - E[x]^2, 0)``, ``rstd = 1/sqrt(var + eps)``, outputs in the
input dtype, plus ``mu`` and ``rstd`` as ``[B, L]`` f32. Backward: with
``a = dy * gamma`` and ``xhat = (x - mu) * rstd``,
``dx = rstd * (a - mean(a) - xhat * mean(a * xhat))`` in the input dtype and
f32 ``dgamma = sum(dy * xhat)``, ``dbeta = sum(dy)`` over rows; the residual
form adds the incoming gradient of the sum and returns one tensor for both
of its inputs. The CUDA kernels are ``csrc/layernorm.cu``; the
``*_reference`` functions are their plain PyTorch versions, used for CPU
tensors and as the kernels' expected values. :class:`LayerNormFn` and
:class:`LayerNormResidualFn` bind the pairs into autograd, saving what the
JAX package's ``custom_vjp`` saves.

The kernels stream tiles of whole rows through a ring in shared memory
(:func:`ring_shape` picks its tile rows and stages). The backward returns
the final dgamma/dbeta from its one launch: its blocks leave partial rows
in a scratch buffer and the last of them sum those in a fixed order, which
a counter array tells them. The library sizes both (:func:`_workspace`,
asked once per width and dtype); the counters are zeroed once for each
device and stream (:func:`_counters`) and left zero by every launch, so
the launches on one stream must run in order, as a stream runs them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "layernorm_fwd"
KERNEL_RES = "layernorm_residual_fwd"
KERNEL_BWD = "layernorm_bwd"
KERNEL_RES_BWD = "layernorm_residual_bwd"
BWD_MAX_VECTORS = 8  # 16-byte vectors per lane the backward keeps in registers
# the rings, (tile rows, stages, shared-memory bytes) at most: the forward's
# within what lets two blocks share an SM, the backward's (one block an SM)
# a tile of a row per consumer warp; chosen by timing ring shapes on the H100
FWD_RING = (8, 4, 110 * 1024)
BWD_RING = (16, 2, 200 * 1024)


def ring_shape(d: int, element_size: int, inputs: int, backward: bool = False) -> tuple[int, int]:
    """``(tile rows, stages)`` of the ring for rows of ``d`` elements of
    ``element_size`` bytes and ``inputs`` staged tensors: the direction's
    ring, with fewer rows and stages (at least 1 and 2) where wide rows
    would pass its bytes."""
    rows, stages, budget = BWD_RING if backward else FWD_RING
    row = d * element_size * inputs
    rows = max(1, min(rows, budget // (2 * row)))
    return rows, max(2, min(stages, budget // (rows * row)))


def _normalize(sf: torch.Tensor, gamma, beta, eps: float, dtype):
    acc = sf.dtype
    mu = sf.mean(dim=-1)
    var = torch.clamp((sf * sf).mean(dim=-1) - mu * mu, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = ((sf - mu[..., None]) * rstd[..., None]) * gamma.to(acc) + beta.to(acc)
    return y.to(dtype), mu, rstd


def layernorm_reference(x, gamma, beta, eps: float = 1e-6):
    """Plain version of K2: ``(y, mu, rstd)``."""
    return _normalize(x.to(_lib.acc_dtype(x.dtype)), gamma, beta, eps, x.dtype)


def layernorm_residual_reference(x, branch, gamma, beta, eps: float = 1e-6):
    """Plain version of K3: ``(s, y, mu, rstd)`` with ``s = x + branch``.

    The statistics and ``y`` use the unrounded f32 sum; ``s`` is returned
    rounded to the input dtype, as in the TPU kernel.
    """
    acc = _lib.acc_dtype(x.dtype)
    sf = x.to(acc) + branch.to(acc)
    y, mu, rstd = _normalize(sf, gamma, beta, eps, x.dtype)
    return sf.to(x.dtype), y, mu, rstd


def _check(x: torch.Tensor, vectors, what: str) -> None:
    _lib.require_cuda(x, what)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 3:
        msg = f"{what}: expected [B, L, D] bfloat16/float32, got {x.dtype} {tuple(x.shape)}"
        raise ValueError(msg)
    d = x.shape[-1]
    if any(v.shape != (d,) for v in vectors):
        msg = f"{what}: gamma/beta must be [{d}]"
        raise ValueError(msg)
    _lib.require_aligned(x, what)


def _vector(t: torch.Tensor) -> torch.Tensor:
    """gamma or beta as the kernels read it: f32, contiguous, 16-byte aligned."""
    t = t.detach().to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, branch, gamma, beta, eps: float, kernel: str):
    _check(x, (gamma, beta), kernel)
    if branch is not None:
        if branch.shape != x.shape or branch.dtype != x.dtype:
            msg = f"{kernel}: branch must match x ({x.dtype} {tuple(x.shape)})"
            raise ValueError(msg)
        _lib.require_aligned(branch, kernel)
    b, l, d = x.shape
    tile_rows, stages = ring_shape(d, x.element_size(), 1 if branch is None else 2)
    gamma, beta = _vector(gamma), _vector(beta)
    y = torch.empty_like(x)
    s = torch.empty_like(x) if branch is not None else None
    mu = torch.empty((b, l), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    code = _lib.library().gdl_layernorm_fwd(
        x.data_ptr(), None if branch is None else branch.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(),
        None if s is None else s.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), b * l, d, tile_rows, stages, float(eps),
        int(x.dtype == torch.bfloat16), _lib.stream_ptr(x),
    )
    _lib.check(code, kernel)
    return s, y, mu, rstd


def layernorm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last dim of ``[B, L, D]`` -> ``(y, mu, rstd)``."""
    if x.device.type == "cpu":
        return layernorm_reference(x, gamma, beta, eps)
    _, y, mu, rstd = _launch(x, None, gamma, beta, eps, KERNEL)
    return y, mu, rstd


def layernorm_residual(x, branch, gamma, beta, eps: float = 1e-6):
    """``s = x + branch; y = LayerNorm(s)`` -> ``(s, y, mu, rstd)``."""
    if x.device.type == "cpu":
        return layernorm_residual_reference(x, branch, gamma, beta, eps)
    return _launch(x, branch, gamma, beta, eps, KERNEL_RES)


def _dx_reference(x, dy, gamma, mu, rstd):
    """``(dx, dgamma, dbeta)`` of LayerNorm, unrounded, by the explicit formula."""
    acc = _lib.acc_dtype(x.dtype)
    xhat = (x.to(acc) - mu[..., None]) * rstd[..., None]
    dyf = dy.to(acc)
    a = dyf * gamma.to(acc)
    t1 = a.mean(dim=-1, keepdim=True)
    t2 = (a * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[..., None] * (a - t1 - xhat * t2)
    rows = tuple(range(x.ndim - 1))
    return dx, (dyf * xhat).sum(dim=rows), dyf.sum(dim=rows)


def layernorm_bwd_reference(x, dy, gamma, mu, rstd):
    """Plain version of K5: ``(dx, dgamma, dbeta)``."""
    dx, dg, db = _dx_reference(x, dy, gamma, mu, rstd)
    return dx.to(x.dtype), dg, db


def layernorm_residual_bwd_reference(s, dy, ds_in, gamma, mu, rstd):
    """Plain version of K6: ``(dx, dgamma, dbeta)`` with ``dx = ds_in +
    LN_dx(dy)`` on the rounded sum ``s``; ``dx`` is the gradient of both
    ``x`` and ``branch``."""
    dx, dg, db = _dx_reference(s, dy, gamma, mu, rstd)
    return (dx + ds_in.to(dx.dtype)).to(s.dtype), dg, db


@functools.cache
def _workspace(index: int, d: int, bf16: bool, residual: bool) -> tuple[int, int, int, int]:
    """``(tile rows, stages, scratch floats, counters)`` of the backward at
    width ``d`` on CUDA device ``index``: the ring, and the scratch and
    tickets that the library says its largest grid there needs."""
    tile_rows, stages = ring_shape(d, 2 if bf16 else 4, 3 if residual else 2, backward=True)
    floats, counters = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(index):
        code = _lib.library().gdl_layernorm_bwd_workspace(
            d, tile_rows, stages, int(bf16), int(residual), ctypes.byref(floats),
            ctypes.byref(counters))
    if code != 0:
        err = _lib.library().gdl_error_string(code).decode()
        msg = f"LayerNorm backward at width {d}: no workspace ({err}, {code})"
        raise RuntimeError(msg)
    return tile_rows, stages, floats.value, counters.value


@functools.cache
def _counters(index: int, stream: int, n: int) -> torch.Tensor:
    """The backward's ``n`` tickets for the launches on ``stream`` of CUDA
    device ``index``: zeroed once, and left zero by every launch that
    completes. Launches on two streams never share them."""
    return torch.zeros(n, dtype=torch.int32, device=torch.device("cuda", index))


def _launch_bwd(x, dy, ds_in, gamma, mu, rstd, kernel: str):
    _check(x, (gamma,), kernel)
    b, l, d = x.shape
    if d // (16 // x.element_size()) > 32 * BWD_MAX_VECTORS:
        msg = f"{kernel}: width {d} above the backward's {32 * BWD_MAX_VECTORS} vectors per row"
        raise ValueError(msg)
    grads = [dy] if ds_in is None else [dy, ds_in]
    for t in grads:
        if t.shape != x.shape or t.dtype != x.dtype:
            msg = f"{kernel}: gradients must match the input ({x.dtype} {tuple(x.shape)})"
            raise ValueError(msg)
        _lib.require_aligned(t, kernel)
    if mu.shape != (b, l) or rstd.shape != (b, l):
        msg = f"{kernel}: mu/rstd must be [{b}, {l}]"
        raise ValueError(msg)
    bf16 = x.dtype == torch.bfloat16
    tile_rows, stages, floats, n = _workspace(x.device.index, d, bf16, ds_in is not None)
    stream = _lib.stream_ptr(x)
    gamma = _vector(gamma)
    mu, rstd = mu.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x)
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    code = _lib.library().gdl_layernorm_bwd(
        x.data_ptr(), dy.data_ptr(), None if ds_in is None else ds_in.data_ptr(),
        gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), db.data_ptr(), scratch.data_ptr(), floats,
        _counters(x.device.index, stream, n).data_ptr(), b * l, d, tile_rows, stages, int(bf16),
        stream,
    )
    _lib.check(code, kernel)
    return dx, dg, db


def layernorm_bwd(x, dy, gamma, mu, rstd):
    """Backward of :func:`layernorm` -> ``(dx, dgamma, dbeta)``."""
    if x.device.type == "cpu":
        return layernorm_bwd_reference(x, dy, gamma, mu, rstd)
    return _launch_bwd(x, dy, None, gamma, mu, rstd, KERNEL_BWD)


def layernorm_residual_bwd(s, dy, ds_in, gamma, mu, rstd):
    """Backward of :func:`layernorm_residual` -> ``(dx, dgamma, dbeta)``."""
    if s.device.type == "cpu":
        return layernorm_residual_bwd_reference(s, dy, ds_in, gamma, mu, rstd)
    return _launch_bwd(s, dy, ds_in, gamma, mu, rstd, KERNEL_RES_BWD)


class LayerNormFn(torch.autograd.Function):
    """``y = LayerNorm(x)`` through K2, backward through K5; saves
    ``(x, gamma, mu, rstd)``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        y, mu, rstd = layernorm(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        ctx.beta_dtype = beta.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, rstd = ctx.saved_tensors
        dx, dg, db = layernorm_bwd(x, dy.to(x.dtype).contiguous(), gamma, mu, rstd)
        return dx, dg.to(gamma.dtype), db.to(ctx.beta_dtype), None


class LayerNormResidualFn(torch.autograd.Function):
    """``(s, y) = (x + branch, LayerNorm(x + branch))`` through K3, backward
    through K6; saves ``(s, gamma, mu, rstd)`` with ``s`` rounded to the
    input dtype and ``mu``/``rstd`` of the unrounded sum."""

    @staticmethod
    def forward(ctx, x, branch, gamma, beta, eps: float):
        s, y, mu, rstd = layernorm_residual(x, branch, gamma, beta, eps)
        ctx.save_for_backward(s, gamma, mu, rstd)
        ctx.beta_dtype = beta.dtype
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, gamma, mu, rstd = ctx.saved_tensors
        dx, dg, db = layernorm_residual_bwd(
            s, dy.to(s.dtype).contiguous(), ds.to(s.dtype).contiguous(), gamma, mu, rstd
        )
        return dx, dx, dg.to(gamma.dtype), db.to(ctx.beta_dtype), None
