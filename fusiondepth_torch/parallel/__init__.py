"""Data parallelism over processes (counterpart of
`fusiondepth_tpu/parallel/`), under the JAX package's export names where
a counterpart exists."""

from fusiondepth_torch.parallel.collectives import (
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_module,
)
from fusiondepth_torch.parallel.mesh import Mesh, make_mesh, rank_rows, \
    shard_batch
from fusiondepth_torch.parallel.multihost import (
    default_device,
    local_batch_size,
    maybe_initialize_distributed,
    process_count,
    process_index,
    shard_lines,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "rank_rows",
    "shard_batch",
    "local_batch_size",
    "maybe_initialize_distributed",
    "shard_lines",
    "default_device",
    "process_count",
    "process_index",
    "all_reduce_sum",
    "all_reduce_grads",
    "all_reduce_mean",
    "barrier",
    "broadcast_module",
]
