"""The data mesh of a data-parallel run (counterpart of
`fusiondepth_tpu/parallel/mesh.py`).

The JAX package builds a 1-D "data" mesh over the chips of its processes,
replicates the parameters and shards batches on the leading axis. torch
runs one process per card, so the mesh here is this process's place in
the default process group: its rank, the world size, its card and the
group the step's collectives run over (`parallel/collectives.py`). The
parameters are replicated (`broadcast_module`), the batch sharded
(`shard_batch`).

The (data, space) mesh of spatial sharding (`make_mesh_2d`,
`shard_batch_spatial`) is not ported: no entry point of the JAX package
reaches it, and its one test fails there (ROADMAP.md §1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fusiondepth_torch.parallel.multihost import default_device, \
    process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """rank of world, on `device`; `group` is None in a world of one."""
    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup]

    @property
    def shape(self) -> Dict[str, int]:
        """{"data": world}, as the JAX Mesh's shape reads."""
        return {"data": self.world}


def make_mesh(shape: Sequence[int] = (),
              device: Optional[torch.device] = None) -> Mesh:
    """This process's place on a 1-D data mesh of `shape` (default: every
    process of the default group). shape=(n,) must be the world size: one
    process asking for n > 1 raises ValueError, since torch runs one
    process per card and the n processes come from the launcher. The
    mesh's card is `device`, else this process's (`default_device`), else
    cuda:0."""
    world = process_count()
    if len(shape) > 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(shape)}: only a 1-D data mesh is ported; "
            "the (data, space) mesh of spatial sharding waits "
            "(ROADMAP.md §1)")
    n = int(shape[0]) if shape else world
    if world == 1 and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            "WORLD_SIZE names several processes but this one has no "
            "process group: call parallel.maybe_initialize_distributed "
            "first (the trainer CLI does)")
    if n != world:
        if world == 1:
            raise ValueError(
                f"mesh_shape ({n},) asks for {n} data-parallel ranks in one "
                f"process; torch runs one process per card, so launch {n} "
                f"processes: torchrun --nproc_per_node {n} -m "
                "fusiondepth_torch.trainer --use_mesh ...")
        raise ValueError(f"mesh_shape ({n},) does not match the {world} "
                         "processes of the process group")
    return Mesh(rank=process_index(), world=world,
                device=torch.device(device) if device is not None
                else default_device() or torch.device("cuda", 0),
                group=dist.group.WORLD if world > 1 else None)


def rank_rows(batch_size: int, mesh: Mesh, accum: int = 1) -> List[int]:
    """The rows of a global batch of `batch_size` that `mesh.rank` holds.
    The global microbatch k is rows [k B/A, (k+1) B/A) (the JAX package's
    microbatching, `fusiondepth_tpu/training/train_state.py:120-122`), and
    each rank holds the rank-th W-th of each, in microbatch order, so that
    its k-th local microbatch is its share of the global k-th; with A = 1,
    rows [r B/W, (r+1) B/W), as the JAX device r holds them."""
    if batch_size % (accum * mesh.world):
        raise NotImplementedError(
            f"batch {batch_size} over {mesh.world} ranks x {accum} "
            "microbatches: the port needs the batch to divide by their "
            "product (the JAX package reshards; ROADMAP.md §1)")
    micro = batch_size // accum
    share = micro // mesh.world
    return [k * micro + mesh.rank * share + i
            for k in range(accum) for i in range(share)]


def shard_batch(batch, mesh: Mesh, accum: int = 1):
    """This rank's rows (`rank_rows`) of every array of a global batch (a
    dict of numpy arrays or tensors)."""
    if mesh.world == 1:
        return batch
    rows = rank_rows(next(iter(batch.values())).shape[0], mesh, accum)
    lo, hi = rows[0], rows[-1] + 1
    if hi - lo == len(rows):
        return {k: v[lo:hi] for k, v in batch.items()}
    idx = np.asarray(rows)
    return {k: v[torch.from_numpy(idx).to(v.device)] if torch.is_tensor(v)
            else v[idx] for k, v in batch.items()}
