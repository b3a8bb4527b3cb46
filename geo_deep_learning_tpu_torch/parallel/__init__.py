"""Data parallelism over one process a rank: the mesh, state placement and
the collectives that GSPMD performs implicitly in the JAX package.

The mesh itself lives in :mod:`geo_deep_learning_tpu_torch.core.mesh`.
Tensor parallelism (``shard_params_spec``, ``TENSOR_PARALLEL_RULES``,
``place_state``, ``count_model_sharded``) is not ported yet.
"""

from geo_deep_learning_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    create_mesh,
    local_batch_to_global,
    shard_batch,
)
from geo_deep_learning_tpu_torch.parallel.collectives import global_sum
from geo_deep_learning_tpu_torch.parallel.placement import model_axis_size, replicate_state

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshConfig",
    "create_mesh",
    "global_sum",
    "local_batch_to_global",
    "model_axis_size",
    "replicate_state",
    "shard_batch",
]
