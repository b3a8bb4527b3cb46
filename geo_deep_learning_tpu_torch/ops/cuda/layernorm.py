"""LayerNorm forward, plain (kernel K2) and residual-fused (kernel K3).

Port of the forward half of ``geo_deep_learning_tpu/ops/pallas/layernorm.py``
for ``[B, L, D]`` token streams: f32 statistics with the fast variance
``max(E[x^2] - E[x]^2, 0)``, ``rstd = 1/sqrt(var + eps)``, outputs in the
input dtype. Both kernels also return ``mu`` and ``rstd`` as ``[B, L]`` f32
(what a backward pass would consume). The CUDA kernels are
``csrc/layernorm.cu``; the ``*_reference`` functions are their plain PyTorch
versions, used for CPU tensors and as the kernels' expected values.
"""

from __future__ import annotations

import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib

KERNEL = "layernorm_fwd"
KERNEL_RES = "layernorm_residual_fwd"


def _normalize(sf: torch.Tensor, gamma, beta, eps: float, dtype):
    mu = sf.mean(dim=-1)
    var = torch.clamp((sf * sf).mean(dim=-1) - mu * mu, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = ((sf - mu[..., None]) * rstd[..., None]) * gamma.float() + beta.float()
    return y.to(dtype), mu, rstd


def layernorm_reference(x, gamma, beta, eps: float = 1e-6):
    """Plain version of K2: ``(y, mu, rstd)``."""
    return _normalize(x.float(), gamma, beta, eps, x.dtype)


def layernorm_residual_reference(x, branch, gamma, beta, eps: float = 1e-6):
    """Plain version of K3: ``(s, y, mu, rstd)`` with ``s = x + branch``.

    The statistics and ``y`` use the unrounded f32 sum; ``s`` is returned
    rounded to the input dtype, as in the TPU kernel.
    """
    sf = x.float() + branch.float()
    y, mu, rstd = _normalize(sf, gamma, beta, eps, x.dtype)
    return sf.to(x.dtype), y, mu, rstd


def _check(x: torch.Tensor, gamma, beta, what: str) -> None:
    _lib.require_cuda(x, what)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 3:
        msg = f"{what}: expected [B, L, D] bfloat16/float32, got {x.dtype} {tuple(x.shape)}"
        raise ValueError(msg)
    d = x.shape[-1]
    if gamma.shape != (d,) or beta.shape != (d,):
        msg = f"{what}: gamma/beta must be [{d}]"
        raise ValueError(msg)
    _lib.require_aligned(x, what)


def _launch(x, branch, gamma, beta, eps: float, kernel: str):
    _check(x, gamma, beta, kernel)
    if branch is not None:
        if branch.shape != x.shape or branch.dtype != x.dtype:
            msg = f"{kernel}: branch must match x ({x.dtype} {tuple(x.shape)})"
            raise ValueError(msg)
        _lib.require_aligned(branch, kernel)
    b, l, d = x.shape
    gamma = gamma.detach().to(torch.float32).contiguous()
    beta = beta.detach().to(torch.float32).contiguous()
    y = torch.empty_like(x)
    s = torch.empty_like(x) if branch is not None else None
    mu = torch.empty((b, l), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    code = _lib.library().gdl_layernorm_fwd(
        x.data_ptr(), None if branch is None else branch.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(),
        None if s is None else s.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), b * l, d, float(eps),
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
