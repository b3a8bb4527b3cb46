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

The model axis (tensor parallelism) has Megatron's two operators over a
model group, which the sharded DOFA and MiT blocks call explicitly (GSPMD
inserts them from the shardings in the JAX package):

- :func:`copy_to_model` sits in front of a column-parallel layer: the
  forward is the identity, the backward all-reduces the gradient, so the
  replicated input (and every replicated parameter before it: LayerNorms,
  the residual stream, LayerScale) sees the gradient of every rank's heads;
- :func:`reduce_from_model` sits after a row-parallel layer: the forward
  all-reduces the ranks' partial products, the backward is the identity
  (unlike :func:`global_sum`, whose backward all-reduces too, which would
  multiply every gradient upstream of the layer by the axis size).

Both sum half-precision tensors in f32 (the ranks' partial sums are added
once, then rounded), which also keeps them off gloo's half-precision path.
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


def _model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous ``x`` summed over ``group`` into a new tensor (in f32
    for half types)."""
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _model_sum(grad.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return _model_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient all-reduced over the model ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` all-reduced over the model ``group``; identity backward."""
    return _ReduceFromModel.apply(x, group)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        group, scale: torch.Tensor | None = None) -> torch.Tensor:
    """A row-parallel ``Linear``: this rank's partial product (its input
    features), :func:`reduce_from_model`, then the replicated bias once
    (inside ``F.linear`` it would be added once a rank). ``scale`` (a
    replicated LayerScale folded into the layer) scales the output
    features of the weight and the bias; its gradient through the weight
    is a partial sum, which :func:`copy_to_model` completes."""
    import torch.nn.functional as F

    if scale is not None:
        weight = weight * copy_to_model(scale, group)[:, None]
        bias = None if bias is None else bias * scale
    y = reduce_from_model(F.linear(x, weight), group)
    return y if bias is None else y + bias.to(y.dtype)


@torch.no_grad()
def average_over_model_(tensors: list[torch.Tensor], group, size: int) -> None:
    """Replace each tensor by its mean over the model ``group`` of ``size``
    ranks, in place, one flat all-reduce a dtype. The train step passes the
    gradients of the replicated parameters: the model ranks compute them
    from equal inputs, but the card's atomic sums (an interpolation's
    backward, say) can leave them a few ulps apart, and the replicas would
    then drift; where they are equal, as on the CPU, the mean is exact."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        dist.all_reduce(flat, group=group)
        flat /= size
        for t, piece in zip(group_tensors, flat.split([t.numel() for t in group_tensors])):
            t.copy_(piece.view_as(t))


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
    """Wait for every rank of the mesh, both axes: one ``all_reduce`` of a
    one-element tensor on the mesh's device, read back."""
    if mesh.parallel or mesh.tensor_parallel:
        flag = torch.ones(1, device=mesh.device)
        dist.all_reduce(flag, group=mesh.group if mesh.model_size == 1 else dist.group.WORLD)
        flag.item()
