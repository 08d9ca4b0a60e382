"""Data, tensor and sequence parallelism, ZeRO-1 and pipeline parallelism
over torch.distributed (counterpart of the JAX package's parallel/).

The sharded train step is train/loop.py's make_train_step(mesh=...), its
optimizer parallel/optim.py's ShardedOptimizer; pipeline.py is GPipe over
the model axis (make_train_step of a module that make_pipelined_module
staged), pipeline_1f1b.py the 1F1B schedule as a library primitive;
multiproc_check.py is the two-process check."""
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
    stage_layers,
    unshard_params,
    zero1_partition,
)
from .pipeline import PipelineSpec, make_pipelined_module, pipeline_stack_apply
from .pipeline_1f1b import pipeline_1f1b_loss_and_grad

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ModelParallel",
    "PipelineSpec",
    "batch_rows",
    "copy_to_model",
    "DataShard",
    "gather_params",
    "initialize_distributed",
    "load_full_state_dict",
    "make_mesh",
    "make_pipelined_module",
    "pad_batch_rows",
    "param_spec",
    "pipeline_1f1b_loss_and_grad",
    "pipeline_stack_apply",
    "reduce_from_model",
    "shard_params",
    "sp_gather",
    "sp_scatter",
    "stage_layers",
    "unshard_params",
    "zero1_partition",
]
