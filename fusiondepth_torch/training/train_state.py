"""The optimizer, the loss function and the train step (counterpart of
`fusiondepth_tpu/training/train_state.py`; reference trainer.py:30-41,
230-266).

One step: forward of every net in training mode (BN running statistics
update in place), view synthesis, losses, backward, Adam. With
cfg.grad_accum_steps > 1 the batch is split into microbatches along its
leading axis; gradients are averaged and the BN statistics carry from one
microbatch to the next, as the JAX package's lax.scan carries them.

With cfg.remat the whole training-mode forward of the nets is one
non-reentrant torch.utils.checkpoint region, the region the JAX package
wraps in jax.checkpoint (`train_forward`): its activations are recomputed
in the backward instead of kept. The recompute runs with the BN
running-statistics update held (`models/norm.py::running_stats_held`), so
the statistics move once a step.

Under compute_dtype="bfloat16" the nets and the loss compute in bf16
over float32 parameters (`models/fusion.py::compute_dtype`): the
gradients arrive float32 at the float32 leaves, and Adam and its state
stay float32, as in the JAX package. bfloat16 runs the default step; the
training variants and remat refuse it (`check_train_supported`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from fusiondepth_torch.config import Config
from fusiondepth_torch.models.fusion import FusionNets, model_dtype, \
    refuse_bf16
from fusiondepth_torch.models.norm import running_stats_held
from fusiondepth_torch.training.photometric import (
    compute_losses,
    generate_images_pred,
)


def check_train_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the train options the port lacks:
    compute_dtype="bfloat16" with any stage-1 training variant or remat
    (bfloat16 trains the default step only)."""
    options = [name for name, on in (
        ("v1_multiscale", cfg.v1_multiscale),
        ("use_stereo", cfg.use_stereo or "s" in cfg.frame_ids),
        ("predictive_mask", cfg.predictive_mask),
        (f"pose_model_type={cfg.pose_model_type!r}",
         cfg.pose_model_type != "separate_resnet"),
        (f"pose_model_input={cfg.pose_model_input!r}",
         cfg.pose_model_input != "pairs"),
        ("remat", cfg.remat)) if on]
    model_dtype(cfg)  # an unknown compute_dtype raises
    if options:
        refuse_bf16(cfg, "the training options " + ", ".join(options))


def check_stage1_variants(cfg: Config, driver: str) -> None:
    """Raise NotImplementedError, with the reason, for the stage-1 training
    variants that `driver` ("completor" or "refiner") refuses: those its
    JAX counterpart cannot run. The completor takes every other variant
    (v1_multiscale, predictive_mask, the posecnn and shared pose types,
    pose_model_input="all"); the refiner takes posecnn, "all", use_stereo
    and predictive_mask (which there only disables the automask: the
    refine loss reads no mask)."""
    if driver == "completor" and cfg.use_stereo:
        raise NotImplementedError(
            "the completor with use_stereo: the completion dataset reads "
            "frame i at the integer offset frame_index + i "
            "(fusiondepth_torch/data/completion_dataset.py:202-207, as "
            "fusiondepth_tpu/data/completion_dataset.py:202-206), so the "
            "stereo frame 's' has no sample")
    if driver == "refiner" and cfg.v1_multiscale:
        raise NotImplementedError(
            "the refiner with v1_multiscale: the refine loss reads the "
            "planes formulation's warped_planes, which the per-scale "
            "formulation does not write (fusiondepth_tpu/training/"
            "refiner.py:242 fails with a KeyError)")
    if driver == "refiner" and cfg.pose_model_type == "shared":
        raise NotImplementedError(
            "the refiner with pose_model_type='shared': the JAX refiner "
            "gives predict_poses frame 0's feature pyramid where the shared "
            "pose decoder reads one pyramid per frame "
            "(fusiondepth_tpu/training/refiner.py:194), and its pose "
            "decoder's squeeze conv then fails on the shape of its input")


def make_optimizer(cfg: Config, nets: torch.nn.Module,
                   steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam,
                              torch.optim.lr_scheduler.LambdaLR]:
    """Adam (eps 1e-8) with the reference's batch-size rescaling
    (trainer.py:39-40: lr *= batch / 8, StepLR step *= 8 / batch) and
    optax's piecewise-constant schedule: x0.1 at each of three step
    boundaries. Call the scheduler's step() after each optimizer step."""
    lr = cfg.learning_rate * (cfg.batch_size / 8.0)
    sched_epochs = int(cfg.scheduler_step_size * (8.0 / cfg.batch_size))
    boundary = max(sched_epochs, 1) * max(steps_per_epoch, 1)
    opt = torch.optim.Adam(nets.parameters(), lr=lr, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** min(step // boundary, 3))
    return opt, sched


def train_forward(cfg: Config, nets: FusionNets,
                  batch: Dict[str, torch.Tensor]) -> Dict[Any, Any]:
    """`nets(batch, train=True)`; with cfg.remat under one non-reentrant
    checkpoint whose recompute holds the BN running statistics."""
    if not cfg.remat:
        return nets(batch, train=True)
    return torch.utils.checkpoint.checkpoint(
        nets, batch, True, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            running_stats_held(nets)))


def loss_fn(cfg: Config, nets: FusionNets, batch: Dict[str, torch.Tensor],
            noise: Optional[Sequence[torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, losses) of one batch, the nets in training mode."""
    outputs = train_forward(cfg, nets, batch)
    outputs = generate_images_pred(cfg, batch, outputs)
    losses = compute_losses(cfg, batch, outputs, noise=noise,
                            generator=generator)
    return losses["loss"], losses


def train_step(cfg: Config, nets: FusionNets, opt: torch.optim.Optimizer,
               sched, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None,
               loss_of: Callable = loss_fn) -> Dict[str, torch.Tensor]:
    """One optimization step of `loss_of` (stage 1's `loss_fn` unless
    given, with its signature); returns the losses, detached (reading them
    is the caller's sync point). `noise` replays the automask noise of a
    single-microbatch step."""
    accum = max(cfg.grad_accum_steps, 1)
    opt.zero_grad(set_to_none=True)
    if accum == 1:
        loss, losses = loss_of(cfg, nets, batch, noise, generator)
        loss.backward()
        losses = {k: v.detach() for k, v in losses.items()}
    else:
        if noise is not None:
            raise ValueError("noise replays a single-microbatch step")
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "microbatches")
        mb = B // accum
        losses = {}
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, ls = loss_of(cfg, nets, part, None, generator)
            (loss / accum).backward()
            for k, v in ls.items():
                losses[k] = losses.get(k, 0.0) + v.detach() / accum
    opt.step()
    sched.step()
    return losses
