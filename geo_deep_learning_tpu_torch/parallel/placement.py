"""State placement over the data axis.

Port of the data-parallel half of ``geo_deep_learning_tpu/parallel/placement.py``:
pure data parallelism replicates the parameters and BatchNorm statistics
on every rank. Every rank builds the model from the same seed; the rank-0
broadcast of :func:`replicate_state` makes that an invariant rather than
an assumption (a pretrained file or a warm start read differently on one
host cannot leave the ranks apart).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from geo_deep_learning_tpu_torch.core.mesh import Mesh


def model_axis_size(mesh: Mesh) -> int:
    """The mesh's model-axis size (always 1 until tensor parallelism)."""
    return mesh.shape["model"]


@torch.no_grad()
def replicate_state(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from rank 0, in
    place, one flat buffer a dtype; a no-op without a group."""
    if not mesh.parallel:
        return module
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(piece.view_as(t))
    return module
