"""Data, tensor and sequence parallelism and ZeRO-1 over torch.distributed
(counterpart of the JAX package's parallel/, without its pipelines).

The sharded train step is train/loop.py's make_train_step(mesh=...), its
optimizer parallel/optim.py's ShardedOptimizer; multiproc_check.py is the
two-process check."""
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    ModelParallel,
    batch_rows,
    copy_to_model,
    DataShard,
    gather_params,
    initialize_distributed,
    load_full_state_dict,
    make_mesh,
    pad_batch_rows,
    param_spec,
    reduce_from_model,
    shard_params,
    sp_gather,
    sp_scatter,
    unshard_params,
    zero1_partition,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ModelParallel",
    "batch_rows",
    "copy_to_model",
    "DataShard",
    "gather_params",
    "initialize_distributed",
    "load_full_state_dict",
    "make_mesh",
    "pad_batch_rows",
    "param_spec",
    "reduce_from_model",
    "shard_params",
    "sp_gather",
    "sp_scatter",
    "unshard_params",
    "zero1_partition",
]
