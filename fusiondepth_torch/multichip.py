"""Data-parallel runs of the port over N processes on one host.

    python -m fusiondepth_torch.multichip N [--device cpu]

is the port of `__graft_entry__.py::dryrun_multichip`: N ranks each build
the stage-1 Trainer with use_mesh (ResNet-18, 64x64, global batch N,
weights_init="scratch", synthetic frames) and run one full step (forward,
view synthesis, losses, gradients and their all-reduce, Adam), then it
prints `dryrun_multichip(N): ok, loss=...`. The ranks use NCCL with one
card each (fewer cards than N raise), or gloo on the CPU with
--device cpu. On a card every training kernel must have launched on every
rank, the counterpart of the JAX dry run's check that its step took the
Pallas kernels.

`spawn` runs such a world: N new processes that meet through a file
store in a temporary directory (no TCP port), each running a rank body of
this module on its device; it returns what each body returned, and a rank
that raises or dies fails the call (the others are stopped). `start`
returns at once, so that the caller can work while the world runs. The bodies
live here, so that the children import the port and nothing else.
`step_rank` runs one Trainer step of given weights on this rank's rows of
a given global batch: `chip_smoke.py` holds two ranks against one process
with it, and the tests hold it against the JAX package.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.kernels import BF16_KERNELS, LAUNCHES, reset_launches
from fusiondepth_torch.models.norm import batch_stats_over, \
    running_stats_held
from fusiondepth_torch.parallel import all_reduce_grads, all_reduce_mean, \
    make_mesh, shard_batch
from fusiondepth_torch.parallel.mesh import Mesh
from fusiondepth_torch.training.train_state import loss_fn
from fusiondepth_torch.training.trainer import Trainer

# the kernels of a stage-1 train step (every kernel but the KNN)
TRAIN_KERNELS = tuple(BF16_KERNELS)
THREADS_PER_RANK = 2


class World:
    """A started world (`start`): join() waits for every rank and returns
    their results, or raises when a rank raised, died or ran past the
    timeout (the others are stopped); close() stops the ranks still
    running."""

    def __init__(self, world: int, body, args, device: str, backend: str):
        self._tmp = tempfile.TemporaryDirectory()
        self._world = world
        self._context = mp.spawn(
            _rank_main, args=(world, self._tmp.name, device, backend, body,
                              tuple(args)), nprocs=world, join=False)

    def join(self, timeout: float = None) -> list:
        """The ranks' results; raises TimeoutError after `timeout` seconds
        (None: no limit) and stops the ranks."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not self._context.join(
                    None if deadline is None
                    else max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"the world of {self._world} ranks "
                                       f"ran past {timeout} s")
            return [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"),
                               map_location="cpu", weights_only=False)
                    for r in range(self._world)]
        finally:
            self.close()

    def close(self) -> None:
        for p in self._context.processes:
            if p.is_alive():
                p.terminate()
            p.join()
        self._tmp.cleanup()


def start(world: int, body: Callable, args: Sequence = (),
          device: str = "cuda", backend: str = None) -> World:
    """Start body(mesh, *args) in `world` new processes and return at once
    (`World.join` collects the results). `device` is "cpu" (gloo),
    "cuda" (NCCL, rank r on cuda:r) or one card for every rank ("cuda:0",
    with backend="gloo": NCCL refuses two ranks on one card)."""
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, one each; "
                           f"{torch.cuda.device_count()} are visible")
    return World(world, body, args, device,
                 backend or ("gloo" if device == "cpu" else "nccl"))


def spawn(world: int, body: Callable, args: Sequence = (),
          device: str = "cuda", backend: str = None) -> list:
    """Run body(mesh, *args) in `world` new processes (`start`) and return
    each rank's result (torch.save-able, on the CPU)."""
    return start(world, body, args, device, backend).join()


def _rank_main(rank, world, tmp, device, backend, body, args):
    torch.set_num_threads(THREADS_PER_RANK)
    dev = torch.device("cuda", rank) if device == "cuda" \
        else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        result = body(make_mesh((world,), dev), *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


def _to(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return [_to(v, device) for v in x]
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean_ms(fn, device: torch.device, n: int) -> float:
    _sync(device)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t) / n * 1e3


def _grads(nets) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().to("cpu", copy=True)
            for n, p in nets.named_parameters() if p.grad is not None}


def _probe(tr: Trainer, batch, noise, bn_global: bool, si_global: bool):
    """The global loss of this rank's step (forward only, the BN running
    statistics held) with its own BatchNorm statistics (bn_global False)
    or its own SI loss (si_global False) in place of the global batch's:
    what a data-parallel step that reduced locally would give."""
    nets, group, mesh = tr.nets, tr.group, tr.mesh
    if not si_global and noise is not None:
        b = batch["color"].shape[0]
        noise = [n[:, mesh.rank * b:(mesh.rank + 1) * b] for n in noise]
    with torch.no_grad(), running_stats_held(nets), \
            batch_stats_over(nets, group if bn_global else None):
        loss, _ = loss_fn(tr.cfg, nets, batch, noise,
                          group=group if si_global else None)
    return float(all_reduce_mean({"loss": loss}, group)["loss"])


def step_rank(mesh: Mesh, spec_path: str) -> Dict[str, Any]:
    """One Trainer step (use_mesh) on this rank's rows of a global batch.
    The spec (torch.load of spec_path) holds "cfg" (Config keyword
    arguments, batch_size the global batch), "weights" (a FusionNets
    state_dict, or the path of one saved by torch.save), "batch" (the
    global host batch) and optionally "noise"
    (the automask noise at the global batch's shape, per microbatch under
    grad_accum_steps; None draws it), "probe" (also run `_probe` both
    ways first) and "time_steps" (then time that many more steps and
    gradient all-reduces). Returns the step's global "loss" and "losses",
    the all-reduced "grads", the nets' "state" after Adam, the kernel
    "launches" of the step, with "probe" the losses "local_bn" and
    "local_si", and with "time_steps" "step_ms" and
    "grad_all_reduce_ms"."""
    spec = torch.load(spec_path, map_location="cpu", weights_only=False)
    # the step reads the batch it is given, no dataset
    cfg = Config(**spec["cfg"]).replace(dataset="synthetic")
    tr = Trainer(cfg, device=mesh.device, use_mesh=True)
    weights = spec["weights"]
    if isinstance(weights, str):
        weights = torch.load(weights, map_location="cpu", weights_only=True)
    tr.nets.load_state_dict(weights)
    batch = tr.put_batch(shard_batch(spec["batch"], tr.mesh,
                                     max(cfg.grad_accum_steps, 1)))
    noise = _to(spec.get("noise"), mesh.device)
    out = {}
    if spec.get("probe"):
        out["local_bn"] = _probe(tr, batch, noise, False, True)
        out["local_si"] = _probe(tr, batch, noise, True, False)
    _sync(mesh.device)
    reset_launches()
    losses = tr.run_step(batch, on_device=True, noise=noise)
    _sync(mesh.device)
    out.update(launches=dict(LAUNCHES),
               loss=float(losses["loss"]),
               losses={k: float(v) for k, v in losses.items()},
               grads=_grads(tr.nets),
               state={k: v.detach().to("cpu", copy=True)
                      for k, v in tr.nets.state_dict().items()})
    n = spec.get("time_steps", 0)
    if n:
        out["step_ms"] = _mean_ms(
            lambda: tr.run_step(batch, on_device=True, noise=noise),
            mesh.device, n)
        out["grad_all_reduce_ms"] = _mean_ms(
            lambda: all_reduce_grads(tr.nets.parameters(), tr.group),
            mesh.device, n)
    return out


def run_all(mesh: Mesh, *calls) -> list:
    """A rank body that runs several: [body(mesh, *args) for (body, args)
    in calls], so that one world serves them all."""
    return [body(mesh, *args) for body, args in calls]


def dryrun_rank(mesh: Mesh, log_dir: str) -> Dict[str, Any]:
    """The rank body of dryrun_multichip: the production path, a Trainer
    with use_mesh (what `torchrun ... -m fusiondepth_torch.trainer
    --use_mesh` builds), one step on its loader's first batch."""
    cfg = Config(num_layers=18, height=64, width=64, batch_size=mesh.world,
                 use_mesh=True, weights_init="scratch", dataset="synthetic",
                 num_workers=1, log_dir=log_dir)
    tr = Trainer(cfg, train_dataset=SyntheticDataset(cfg, length=mesh.world),
                 device=mesh.device)
    if tr.mesh is None or tr.mesh.shape["data"] != mesh.world:
        raise RuntimeError(f"the Trainer's mesh is {tr.mesh}")
    batch = next(iter(tr._loader(tr.train_dataset, shuffle=False)))
    reset_launches()
    loss = float(tr.run_step(batch)["loss"])
    launches = dict(LAUNCHES)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if mesh.device.type == "cuda":
        missed = [k for k in TRAIN_KERNELS if not launches[k]]
        if missed:
            raise RuntimeError(f"rank {mesh.rank} launched no {missed}")
    return {"loss": loss, "launches": launches}


def dryrun_multichip(n: int, device: str = "cuda") -> float:
    """One data-parallel Trainer step over n ranks; returns its loss."""
    with tempfile.TemporaryDirectory() as tmp:
        results = spawn(n, dryrun_rank, (tmp,), device)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise RuntimeError(f"the ranks disagree on the global loss: "
                           f"{sorted(losses)}")
    loss = results[0]["loss"]
    print(f"dryrun_multichip({n}): ok, loss={loss:.4f}, device={device}",
          flush=True)
    return loss


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=8,
                   help="ranks (processes)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="one card per rank with NCCL, or the CPU with gloo")
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
