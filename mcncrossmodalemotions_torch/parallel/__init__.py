"""Synchronous data parallelism over ``torch.distributed`` (``mesh.py``)."""

from mcncrossmodalemotions_torch.parallel.mesh import (
    DATA_AXIS,
    DataMesh,
    all_reduce_sum,
    all_reduce_tensors,
    auto_mesh,
    barrier,
    gather_rows,
    initialize_multihost,
    make_mesh,
    pad_to_multiple,
    process_index,
    shard_batch,
    world_size,
)

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "all_reduce_sum",
    "all_reduce_tensors",
    "auto_mesh",
    "barrier",
    "gather_rows",
    "initialize_multihost",
    "make_mesh",
    "pad_to_multiple",
    "process_index",
    "shard_batch",
    "world_size",
]
