"""Parallelism over one process a rank: the mesh, state placement and the
collectives that GSPMD performs implicitly in the JAX package.

The mesh itself lives in :mod:`geo_deep_learning_tpu_torch.core.mesh`: a
data axis (batches split, gradients averaged by DDP) and a model axis
(tensor parallelism: :data:`TENSOR_PARALLEL_RULES`, :func:`place_state`).
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
from geo_deep_learning_tpu_torch.parallel.collectives import (
    copy_to_model,
    global_sum,
    reduce_from_model,
)
from geo_deep_learning_tpu_torch.parallel.placement import (
    TENSOR_PARALLEL_RULES,
    Split,
    count_model_sharded,
    gather_train_state,
    local_train_state,
    model_axis_size,
    place_state,
    replicate_state,
    shard_params,
    shard_params_spec,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "TENSOR_PARALLEL_RULES",
    "Mesh",
    "MeshConfig",
    "Split",
    "copy_to_model",
    "count_model_sharded",
    "create_mesh",
    "gather_train_state",
    "global_sum",
    "local_batch_to_global",
    "local_train_state",
    "model_axis_size",
    "place_state",
    "reduce_from_model",
    "replicate_state",
    "shard_batch",
    "shard_params",
    "shard_params_spec",
]
