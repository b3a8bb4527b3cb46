"""The collectives that GSPMD inserts implicitly in the JAX package.

In the JAX package a reduction over the batch axis of a batch sharded on
``data`` is global: XLA adds the cross-device ``psum``. With one process a
rank the port says so explicitly:

- :func:`global_sum` is a differentiable ``all_reduce`` (sum) whose
  backward all-reduces the gradient. A loss is ``f(S)`` with
  ``S = sum_r s_r``; each rank's backward then gives
  ``W * f'(S) * ds_r/dtheta``, and ``DistributedDataParallel``'s mean over
  the ranks is exactly ``dL/dtheta`` of the global batch. The losses
  (``ops/losses.py``) and the train-mode BatchNorm
  (``models/layers.py``) take every batch sum through it.
- It reduces over the group of the innermost :func:`reduce_over` context
  (the steps enter one for a batch split over the ranks, as the JAX
  package's steps enter their compute mesh); outside one, or for a
  replicated batch, it returns its input itself, so a run without a group
  computes exactly what it did before.
- :func:`all_reduce_sum_` and :func:`gather_rows` serve the metrics and
  the prediction output; only ``all_reduce`` and ``broadcast`` are used,
  so the same code runs on NCCL and on gloo with CUDA tensors.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch
import torch.distributed as dist

from geo_deep_learning_tpu_torch.core.mesh import Mesh, is_sharded

_REDUCE = threading.local()


def current_group():
    """The process group batch sums reduce over here (None: local)."""
    return getattr(_REDUCE, "group", None)


@contextlib.contextmanager
def reduce_over(group) -> Iterator[None]:
    """Make batch sums inside reduce over ``group`` (None: locally)."""
    prev = current_group()
    _REDUCE.group = group
    try:
        yield
    finally:
        _REDUCE.group = prev


def batch_context(mesh: Mesh | None, batch: dict):
    """:func:`reduce_over` the mesh's group when ``batch`` is this rank's
    block of a split global batch; locally for a replicated one."""
    return reduce_over(mesh.group if is_sharded(batch, mesh) else None)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the current :func:`reduce_over`
    group, differentiably; ``t`` itself without a group."""
    group = current_group()
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x``'s elements over every rank's ``x``: ``x.mean()``
    without a group; the element count is summed in f64."""
    if current_group() is None:
        return x.mean()
    s = global_sum(torch.stack([x.sum().double(),
                                torch.tensor(float(x.numel()), dtype=torch.float64,
                                             device=x.device)]))
    return (s[0] / s[1]).to(x.dtype)


@torch.no_grad()
def all_reduce_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh's ranks in place (no autograd); a no-op
    without a group."""
    if mesh.parallel:
        dist.all_reduce(t, group=mesh.group)
    return t


@torch.no_grad()
def gather_rows(t: torch.Tensor, mesh: Mesh, start: int, global_rows: int) -> torch.Tensor:
    """The global batch's ``[global_rows, ...]`` tensor on every rank, from
    each rank's rows ``[start, start + len(t))``: zeros elsewhere, one
    ``all_reduce``, so every value arrives unchanged."""
    out = torch.zeros((global_rows, *t.shape[1:]), dtype=t.dtype, device=t.device)
    out[start:start + t.shape[0]] = t
    return all_reduce_sum_(out, mesh)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank: one ``all_reduce`` of a one-element tensor on
    the mesh's device, read back."""
    if mesh.parallel:
        flag = torch.ones(1, device=mesh.device)
        dist.all_reduce(flag, group=mesh.group)
        flag.item()
