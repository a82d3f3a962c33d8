"""The optimizer, the loss function and the train step (counterpart of
`fusiondepth_tpu/training/train_state.py`; reference trainer.py:30-41,
230-266).

One step: forward of every net in training mode (BN running statistics
update in place), view synthesis, losses, backward, Adam. With
cfg.grad_accum_steps > 1 the batch is split into microbatches along its
leading axis; gradients are averaged and the BN statistics carry from one
microbatch to the next, as the JAX package's lax.scan carries them.

Not ported yet: `remat` (recomputing through torch.utils.checkpoint would
update the BN running statistics twice) and bfloat16 compute
(`models/fusion.py::model_dtype`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.models.fusion import FusionNets, model_dtype
from fusiondepth_torch.training.photometric import (
    compute_losses,
    generate_images_pred,
)


def check_train_supported(cfg: Config) -> None:
    """Raise NotImplementedError for train options the port lacks: remat
    and bfloat16."""
    model_dtype(cfg)
    if cfg.remat:
        raise NotImplementedError(
            "remat: not ported to fusiondepth_torch yet (recomputing the "
            "forward would update the BN running statistics twice)")


def check_stage1_default(cfg: Config, where: str) -> None:
    """Raise NotImplementedError for the stage-1 training variants that
    `where` (the refiner, the completor) has not been held with against
    the JAX package: v1_multiscale, use_stereo, predictive_mask, and pose
    nets other than separate_resnet over frame pairs."""
    on = [f for f in ("v1_multiscale", "use_stereo", "predictive_mask")
          if getattr(cfg, f)]
    if cfg.pose_model_type != "separate_resnet":
        on.append(f"pose_model_type={cfg.pose_model_type!r}")
    if cfg.pose_model_input != "pairs":
        on.append(f"pose_model_input={cfg.pose_model_input!r}")
    if on:
        raise NotImplementedError(
            f"{where} with {', '.join(on)}: not ported to fusiondepth_torch "
            "yet")


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


def loss_fn(cfg: Config, nets: FusionNets, batch: Dict[str, torch.Tensor],
            noise: Optional[Sequence[torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, losses) of one batch, the nets in training mode."""
    outputs = nets(batch, train=True)
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
