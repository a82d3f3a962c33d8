"""Multi-process bring-up and per-process input sharding (counterpart of
`fusiondepth_tpu/parallel/multihost.py`).

torch runs one process per card, so every data-parallel run is a
multi-process run here:

  - `maybe_initialize_distributed` connects the processes with
    `torch.distributed.init_process_group` (NCCL between cards, gloo on
    the CPU), from the --coordinator_address / --num_processes /
    --process_id flags or from the RANK / WORLD_SIZE / LOCAL_RANK
    variables that `torchrun` sets (the counterpart of JAX's
    environment auto-detection);
  - each process reads a disjoint slice of the training split
    (`shard_lines`) and loads `local_batch_size` samples a step.

`global_batch` has no counterpart. JAX assembles the processes' local
arrays into one globally sharded `jax.Array`; here a rank keeps its local
tensors, and the step's collectives (`parallel/collectives.py`: the
batch-global BatchNorm statistics, the SI loss and the gradient
all-reduce) make its batch reductions global.

Everything here is a no-op in a single-process run, so the same Trainer
code serves one card and N.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def process_count() -> int:
    """The number of processes in the default process group (1 without
    one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


# shard_lines and local_batch_size take parameters of these names
_count, _index = process_count, process_index


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_card() -> int:
    """The card of this process: LOCAL_RANK when torchrun set it, else the
    rank modulo the cards this host has."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(torch.cuda.device_count(), 1)


def default_device() -> Optional[torch.device]:
    """cuda:LOCAL_RANK when this process is one of several, else None (an
    entry point then takes cuda:0)."""
    if process_count() > 1:
        return torch.device("cuda", local_card())
    return None


def maybe_initialize_distributed(cfg, device=None) -> bool:
    """Join this process to the others when multi-process flags are set:
    --coordinator_address "host:port" (-> tcp://host:port), --num_processes
    (the world size) and --process_id (the rank), where a flag left at its
    default is read from torchrun's variables (WORLD_SIZE, RANK, and
    MASTER_ADDR/MASTER_PORT through env://). A no-op, returning False, when
    no flag names a coordinator or more than one process and WORLD_SIZE
    does not either, as the JAX version is without its flags.

    The backend is NCCL, with this process's card (`local_card`) made the
    current one, unless `device` is the CPU, where it is gloo. Raises when
    the card or NCCL is missing: there is no fallback to the CPU or to a
    single process. Returns True once the group is up."""
    if (cfg.coordinator_address is None and cfg.num_processes <= 1
            and _env_world() <= 1):
        return False
    if dist.is_initialized():
        raise RuntimeError("maybe_initialize_distributed: a process group "
                           "is already initialized")
    world = (cfg.num_processes if cfg.num_processes > 1
             or "WORLD_SIZE" not in os.environ else _env_world())
    if cfg.process_id >= 0:
        rank = cfg.process_id
    elif "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    elif world == 1:
        rank = 0
    else:
        raise ValueError(
            f"a world of {world} processes needs this one's rank: pass "
            "--process_id, or launch with torchrun (which sets RANK)")
    init_method = (f"tcp://{cfg.coordinator_address}"
                   if cfg.coordinator_address else "env://")
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("multi-process training runs on CUDA cards "
                               "and none is available; pass device='cpu' "
                               "to run on the CPU with gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL backend")
        torch.cuda.set_device(local_card())
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return True


def shard_lines(lines: Sequence[str],
                process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> list:
    """This process's strided slice of the split's file lines.

    Truncates to a per-process-equal count so every process runs the same
    number of steps (collectives stay aligned). Single-process: identity.
    The defaults come from the default process group."""
    pc = process_count if process_count is not None else _count()
    pi = process_index if process_index is not None else _index()
    if not 0 <= pi < pc:
        raise ValueError(f"process index {pi} outside 0..{pc - 1}")
    if pc == 1:
        return list(lines)
    n = (len(lines) // pc) * pc
    return list(lines[pi:n:pc])


def local_batch_size(global_batch_size: int,
                     process_count: Optional[int] = None) -> int:
    """Per-process batch size for a global batch. The global size must
    divide evenly: uneven batches would desynchronize the data-parallel
    collectives."""
    pc = process_count if process_count is not None else _count()
    if global_batch_size % pc:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {pc} processes")
    return global_batch_size // pc
