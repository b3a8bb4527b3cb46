"""State placement over the mesh: replicated over the data axis, Megatron
shards over the model axis.

Port of ``geo_deep_learning_tpu/parallel/placement.py``. Pure data
parallelism replicates the parameters and BatchNorm statistics on every
rank. Every rank builds the model from the same seed; the rank-0 broadcast
of :func:`replicate_state` makes that an invariant rather than an
assumption (a pretrained file or a warm start read differently on one host
cannot leave the ranks apart).

Tensor parallelism (a model axis ``M > 1``): :data:`TENSOR_PARALLEL_RULES`
names, by the port's parameter names, the column-parallel layers (output
features split: the attention's ``qkv`` / ``q`` / ``kv``, ``fc1``, the
Mix-FFN's depthwise conv, with their biases) and the row-parallel ones
(input features split: ``proj`` and ``fc2``; their biases stay
replicated and are added once, after the sum over the ranks). The JAX
package lays the same shards out as ``NamedSharding``s and lets GSPMD emit
the collectives; here :func:`place_state` cuts each rank's shard out of the
whole parameters in place, and the blocks call the two collectives
themselves (``parallel.collectives.copy_to_model`` /
``row_parallel_linear``). The kernels see plain local tensors, never a
``DTensor``: each rank already holds its heads and rows, which is the role
``ops/pallas/spmd.py::maybe_shard_map`` plays for the Pallas kernels in the
JAX package, so no ``shard_map`` counterpart is needed.

By design, unlike the JAX package:

- the packed ``qkv [3D, D]`` (``[q heads | k heads | v heads]``) and MiT's
  ``kv [2D, D]`` are cut head-aligned within each third or half
  (:class:`Split` ``parts``): rank r takes ``q[r], k[r], v[r]``, so the
  attention's ``chunk(3)`` still finds its thirds; a contiguous cut would
  give rank 0 all of q and half of k;
- a block is sharded only where M divides its heads (attention) or its
  hidden width (MLP); otherwise all of its leaves stay replicated (the JAX
  package column-shards MiT's one-head ``q`` and lets GSPMD reshard around
  the attention; a head cut in the middle cannot be computed locally);
- :func:`count_model_sharded` counts the packed ``qkv`` as one leaf (72
  for DOFA-base, where the JAX package's separate q, k, v count 120);
- a checkpoint holds whole tensors (:func:`gather_train_state`), so any
  layout restores it (:func:`local_train_state`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from geo_deep_learning_tpu_torch.core.mesh import Mesh

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Split:
    """A tensor cut over the model axis along ``dim``, in ``parts`` equal
    blocks each cut on its own (``q | k | v``: 3; ``k | v``: 2)."""

    dim: int
    parts: int = 1


# (parameter-name substring, split): first match wins. Linear weights are
# [out, in]: a column-parallel layer cuts dim 0, a row-parallel one dim 1.
TENSOR_PARALLEL_RULES: list[tuple[str, Split]] = [
    # DOFA ViT: packed [q heads | k heads | v heads]
    ("attn.qkv.weight", Split(0, 3)),
    ("attn.qkv.bias", Split(0, 3)),
    # MiT SR attention: q, and packed [k heads | v heads]
    ("attn.q.weight", Split(0)),
    ("attn.q.bias", Split(0)),
    ("attn.kv.weight", Split(0, 2)),
    ("attn.kv.bias", Split(0, 2)),
    # both families: the attention's output and the MLP
    ("attn.proj.weight", Split(1)),
    ("mlp.fc1.weight", Split(0)),
    ("mlp.fc1.bias", Split(0)),
    # MiT's depthwise 3x3 [hidden, 1, 3, 3] acts by channel
    ("mlp.dwconv.dwconv.weight", Split(0)),
    ("mlp.dwconv.dwconv.bias", Split(0)),
    ("mlp.fc2.weight", Split(1)),
]


def model_axis_size(mesh: Mesh) -> int:
    """The mesh's model-axis size."""
    return mesh.shape["model"]


def _match(name: str, rules: list | None) -> Split | None:
    for substr, split in rules or []:
        if substr in name:
            return split
    return None


def _divisible(shape: tuple, split: Split, size: int) -> bool:
    """A split is usable only where its blocks divide evenly."""
    return split.dim < len(shape) and shape[split.dim] % (split.parts * size) == 0


def _blocks(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """The modules that can be sharded (they carry ``tp_divisor``: the
    heads or the hidden width that the model axis must divide)."""
    return [(n, m) for n, m in model.named_modules() if hasattr(m, "tp_divisor")]


def shard_params_spec(model: nn.Module, size: int,
                      rules: list | None = None) -> dict[str, Split | None]:
    """Every parameter name -> its :class:`Split` over a model axis of
    ``size``, or None (replicated). With no rules (the default) everything
    is replicated, which is data parallelism; pass
    :data:`TENSOR_PARALLEL_RULES` for the Megatron layout. A block whose
    ``tp_divisor`` ``size`` does not divide, or one of whose matched leaves
    does not divide, stays wholly replicated."""
    spec: dict[str, Split | None] = {n: None for n, _ in model.named_parameters()}
    if size <= 1 or not rules:
        return spec
    for prefix, block in _blocks(model):
        leaves = {f"{prefix}.{n}": p for n, p in block.named_parameters()}
        matched = {n: _match(n, rules) for n in leaves}
        matched = {n: s for n, s in matched.items() if s is not None}
        if not matched or block.tp_divisor % size:
            continue
        if all(_divisible(tuple(leaves[n].shape), s, size) for n, s in matched.items()):
            spec.update(matched)
    return spec


def _shard_view(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of a whole tensor ``t`` as a view whose split
    dim is unflattened into ``(parts, block)``."""
    d = split.dim
    blocks = t.unflatten(d, (split.parts, size, t.shape[d] // (split.parts * size)))
    return blocks.select(d + 1, rank)


def local_slice(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of a whole tensor ``t``."""
    return _shard_view(t, split, rank, size).flatten(split.dim, split.dim + 1)


def shard_params(state: dict[str, torch.Tensor], spec: dict[str, Split | None], rank: int,
                 size: int) -> dict[str, torch.Tensor]:
    """A whole state dict with each tensor that ``spec`` splits cut to rank
    ``rank``'s shard (contiguous copies); the others as they are."""
    return {n: local_slice(t, spec[n], rank, size).contiguous() if spec.get(n) else t
            for n, t in state.items()}


def _fix_shapes(module: nn.Module) -> None:
    """Keep a sliced layer's size attributes true to its local weight."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
        elif isinstance(m, nn.Conv2d) and m.groups == m.in_channels == m.out_channels:
            m.groups = m.in_channels = m.out_channels = m.weight.shape[0]


@torch.no_grad()
def place_state(model: nn.Module, mesh: Mesh, rules: list | None = None) -> nn.Module:
    """Cut ``model``'s whole parameters to this rank's shards, in place,
    under ``rules`` over the mesh's model axis (an optimizer built after
    this lays its moments out alike). Each sharded parameter is tagged
    with its :class:`Split` (``model_split``), each sharded block gets the
    mesh as ``tp``, every DOFA attention the model axis (``model_axis``,
    which routes it to K8/K9), and the model records the layout in
    ``tp_layout``. With no rules, or a model axis of 1, nothing changes."""
    size = model_axis_size(mesh)
    if size <= 1 or not rules:
        return model
    spec = shard_params_spec(model, size, rules)
    params = dict(model.named_parameters())
    layout = {n: s for n, s in spec.items() if s is not None}
    for name, split in layout.items():
        p = params[name]
        p.data = local_slice(p.data, split, mesh.model_rank, size).contiguous()
        p.model_split = split
    for prefix, block in _blocks(model):
        if hasattr(block, "model_axis"):
            block.model_axis = size
        if any(n.startswith(prefix + ".") for n in layout):
            block.tp = mesh
            _fix_shapes(block)
    model.tp_layout = layout
    model.tp_mesh = mesh
    if not layout:
        logger.warning("mesh has model axis %d but no parameter matched the tensor-parallel "
                       "rules; running fully replicated", size)
    else:
        replicated = [p for p, b in _blocks(model) if b.tp is None]
        logger.info("tensor parallelism: %d param tensors sharded over model axis of size %d"
                    "%s", len(layout), size,
                    f"; replicated blocks (heads or width not divisible): {replicated}"
                    if replicated else "")
    return model


def count_model_sharded(model: nn.Module) -> int:
    """Number of parameter tensors actually sharded over the model axis."""
    return sum(getattr(p, "model_split", None) is not None for p in model.parameters())


@torch.no_grad()
def gather_tensor(t: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's shard ``t``: each rank
    writes its shard into zeros and one ``all_reduce`` (which gloo runs on
    CUDA tensors too) sums them, so every value arrives unchanged."""
    shape = list(t.shape)
    shape[split.dim] *= mesh.model_size
    whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
    _shard_view(whole, split, mesh.model_rank, mesh.model_size).copy_(
        t.unflatten(split.dim, (split.parts, -1)))
    dist.all_reduce(whole, group=mesh.model_group)
    return whole


def _optimizer_splits(optimizer: torch.optim.Optimizer) -> dict[int, Split]:
    """Optimizer state index (its ``state_dict`` numbering) -> the split of
    a sharded parameter."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: p.model_split for i, p in enumerate(params)
            if getattr(p, "model_split", None) is not None}


def _map_optimizer(opt_state: dict, splits: dict[int, Split], fn) -> dict:
    """``opt_state`` with ``fn(tensor, split)`` applied to every slot of a
    sharded parameter that is not a scalar (Adam's moments, SGD's momentum;
    ``step`` is a scalar)."""
    state = {i: {k: fn(v, splits[i]) if i in splits and torch.is_tensor(v) and v.ndim else v
                 for k, v in slots.items()}
             for i, slots in opt_state["state"].items()}
    return {**opt_state, "state": state}


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded tensor whole, gathered over
    the model group (every model rank must call it); the state dict itself
    without a layout."""
    state = model.state_dict()
    layout = getattr(model, "tp_layout", None)
    if not layout:
        return state
    return {n: gather_tensor(t, layout[n], model.tp_mesh) if n in layout else t
            for n, t in state.items()}


def local_state_dict(state: dict[str, torch.Tensor], model: nn.Module) -> dict:
    """A whole state dict cut to ``model``'s layout (itself without one)."""
    layout = getattr(model, "tp_layout", None)
    if not layout:
        return state
    mesh = model.tp_mesh
    return shard_params(state, layout, mesh.model_rank, mesh.model_size)


def gather_train_state(state) -> dict:
    """``state.state_dict()`` (a ``TrainState``) with the model and the
    optimizer state whole: the checkpoint format of a one-process run.
    Every model rank must call it."""
    out = state.state_dict()
    model = state.model
    if not getattr(model, "tp_layout", None):
        return out
    mesh = model.tp_mesh
    out["model"] = full_state_dict(model)
    out["optimizer"] = _map_optimizer(out["optimizer"], _optimizer_splits(state.optimizer),
                                      lambda t, s: gather_tensor(t, s, mesh))
    return out


def local_train_state(saved: dict, state) -> dict:
    """A whole checkpoint (any layout's) cut to ``state``'s layout."""
    model = state.model
    if not getattr(model, "tp_layout", None):
        return saved
    mesh = model.tp_mesh
    rank, size = mesh.model_rank, mesh.model_size
    return {**saved, "model": local_state_dict(saved["model"], model),
            "optimizer": _map_optimizer(saved["optimizer"], _optimizer_splits(state.optimizer),
                                        lambda t, s: local_slice(t, s, rank, size).contiguous())}


@torch.no_grad()
def replicate_state(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from global rank
    0 to every rank of the mesh, both axes (call it before
    :func:`place_state`), in place, one flat buffer a dtype; a no-op
    without a group."""
    if not (mesh.parallel or mesh.tensor_parallel):
        return module
    group = mesh.group if mesh.model_size == 1 else dist.group.WORLD
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        dist.broadcast(flat, src=0, group=group)
        for t, piece in zip(group_tensors, flat.split([t.numel() for t in group_tensors])):
            t.copy_(piece.view_as(t))
    return module
