"""Data parallelism over several cards (counterpart of ``grl_tpu/parallel``):
one process per card, grouped by ``torch.distributed``."""

from .launch import launch
from .mesh import (
    Mesh,
    auto_mesh,
    current_mesh,
    data_mesh,
    replicate,
    row_block,
    shard_batch,
    sharded_cosine_distance,
    sharded_train_state,
    visible_devices,
)
from .multihost import (
    coordination_barrier,
    destroy_group,
    establish_collectives,
    eval_catalog_meta,
    gather_striped_rows,
    init_group,
    maybe_initialize_distributed,
    min_shard_size,
    shard_catalog,
    stripe_catalog,
)

__all__ = [
    "Mesh",
    "auto_mesh",
    "coordination_barrier",
    "current_mesh",
    "data_mesh",
    "destroy_group",
    "establish_collectives",
    "eval_catalog_meta",
    "gather_striped_rows",
    "init_group",
    "launch",
    "maybe_initialize_distributed",
    "min_shard_size",
    "replicate",
    "row_block",
    "shard_batch",
    "sharded_cosine_distance",
    "shard_catalog",
    "sharded_train_state",
    "stripe_catalog",
    "visible_devices",
]
