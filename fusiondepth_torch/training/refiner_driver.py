"""Stage-2 refiner driver (reference refiner.py:25-264; counterpart of
`fusiondepth_tpu/training/refiner_driver.py`): loads the frozen stage-1
weights, trains only the refine2d decoder on the GDC-clone objective, and
validates on the eigen test split with best-AbsRel checkpointing. With
train_entire_net the stage-1 parameters train too, in the same Adam, their
BatchNorm in eval mode with its running statistics fixed.

Runs on one card (cuda:0 unless `device` names another; device="cpu" for
the tests), TF32 off. The optimizer is optax.adam(lr * batch / 8) of the
JAX package, which is torch's Adam with eps 1e-8 outside the square root
and a constant rate. Checkpoints hold the refine decoder (and with
train_entire_net the fine-tuned stage-1 nets, under their own names, the
JAX bundle's `stage1_variables`) and the optimizer state, laid out as
`training/checkpoint.py` lays out stage 1's, under
{log_dir}/{model_name}_refine/models/weights_{tag}; `load` also takes a
`.npz` of the JAX variables (keys "refine2d/params/...", "encoder/...";
`scripts/convert_checkpoint.py` writes one from a JAX refine checkpoint).

Stage-1 variants: see `train_state.py::check_stage1_variants`. Not
ported, and refused with NotImplementedError: the sparse-3D family
(refine_shallow, refineUnet, refine_deep).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.data.prefetch import prefetch_to_device
from fusiondepth_torch.models.fusion import model_dtype, refuse_bf16
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.evaluation import evaluate_disparities
from fusiondepth_torch.training.infer_driver import device_batch, \
    resolve_device
from fusiondepth_torch.training.refiner import REFINE_KEYS, RefinerNets, \
    refine_loss
from fusiondepth_torch.training.train_state import check_stage1_variants, \
    check_train_supported
from fusiondepth_torch.utils.logging import MetricLogger, sec_to_hm_str

# what the refined inference reads; every one is an NHWC image
INFER_KEYS = ("color_aug", "two_channel", "four_beam", "K")


class Refiner:
    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 device=None):
        unported = [f for f in ("refine_shallow", "refineUnet",
                                "refine_deep") if getattr(cfg, f)]
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)}: not ported to fusiondepth_torch "
                "yet; use the JAX package's refiner")
        # the reference forces these on (refiner.py:29-30)
        cfg = cfg.replace(clone_gdc=True, refine_2d=True)
        refuse_bf16(cfg, "the refiner")
        check_train_supported(cfg)
        check_stage1_variants(cfg, "refiner")
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = model_dtype(cfg)
        self.nets = RefinerNets(cfg, device=self.device,
                                generator=torch.Generator().manual_seed(
                                    cfg.seed + 2))
        if cfg.refine_load_weights_folder and os.path.exists(
                cfg.refine_load_weights_folder):
            ckpt.load_checkpoint(cfg.refine_load_weights_folder,
                                 self.nets.stage1)
        else:
            print(f"WARNING: refine_load_weights_folder "
                  f"{cfg.refine_load_weights_folder!r} not found — the "
                  "frozen stage 1 keeps its random init")
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.optimizer = torch.optim.Adam(
            self._bundle().parameters(),
            lr=cfg.learning_rate * (cfg.batch_size / 8.0), eps=1e-8)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 3)
        self.log_path = os.path.join(cfg.log_dir, cfg.model_name + "_refine")
        self.loggers = {m: MetricLogger(self.log_path, m, use_tb=False)
                        for m in ("train", "val")}
        self.best_absrel = float("inf")
        self.step = 0
        self._t0 = time.time()

    def _bundle(self) -> torch.nn.Module:
        """The trained and checkpointed module: the refine decoder under
        `refine2d`, and with train_entire_net each stage-1 net under its
        own name."""
        nets = {"refine2d": self.nets.refine2d}
        if self.cfg.train_entire_net:
            nets.update(self.nets.stage1.named_children())
        return torch.nn.ModuleDict(nets)

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> the step's inputs on the card, in the model
        dtype."""
        return device_batch(batch, self.device, REFINE_KEYS, self.dtype)

    def run_step(self, batch, on_device: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """One refine step; returns its losses (tensors on the card)."""
        db = batch if on_device else self.put_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss, losses = refine_loss(self.cfg, self.nets, db,
                                   generator=self.generator)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def run_epoch(self, epoch: int = 0) -> List[torch.Tensor]:
        """One pass over the train split; returns each step's loss."""
        cfg = self.cfg
        loader = DataLoader(self.train_dataset, cfg.batch_size, shuffle=True,
                            drop_last=True, num_workers=cfg.num_workers)
        step_losses = []
        for db in prefetch_to_device(loader, self.put_batch, size=2):
            losses = self.run_step(db, on_device=True)
            step_losses.append(losses["loss"])
            if self.step % cfg.log_frequency == 0:
                loss = float(losses["loss"])  # the sync point
                print(f"refine epoch {epoch} step {self.step} "
                      f"loss {loss:.4f} "
                      f"({sec_to_hm_str(time.time() - self._t0)})",
                      flush=True)
                self.loggers["train"].log_scalars(self.step, {"loss": loss})
        return step_losses

    def train(self) -> None:
        for epoch in range(self.cfg.num_epochs):
            self.run_epoch(epoch)
            self.validate()

    @torch.inference_mode()
    def infer(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Refined scale-0 disparity (B, H, W, 1) of one device batch:
        stage-1 forward, pseudo-3D maps, refine decoder."""
        outputs, feats, beam_feats = self.nets.frozen_forward(
            batch, poses=False)
        maps = self.nets.build_pseudo3d(batch, outputs)
        return self.nets.refine(feats, beam_feats, maps)[("disp", 0)]

    def validate(self) -> Optional[Dict[str, float]]:
        if self.val_dataset is None:
            return None
        loader = DataLoader(self.val_dataset, self.cfg.eval_batch_size)
        disps, gts = [], []
        for batch in loader:
            disp = self.infer(device_batch(batch, self.device, INFER_KEYS,
                                           self.dtype))
            disps.extend(disp[..., 0].float().cpu().numpy())
            gts.extend(batch.get("depth_gt", []))
        if not gts:
            return None
        metrics = evaluate_disparities(disps, gts)
        self.loggers["val"].log_scalars(self.step, metrics)
        print("refine val | " + " | ".join(
            f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
        if metrics["abs_rel"] < self.best_absrel:
            self.best_absrel = metrics["abs_rel"]
            self.save("best_refine")
        return metrics

    def save(self, tag: str) -> str:
        """Save the refine decoder (and with train_entire_net the stage-1
        nets) and the optimizer state; returns the weights folder."""
        cfg = self.cfg.replace(model_name=self.cfg.model_name + "_refine")
        return ckpt.save_checkpoint(cfg, self._bundle(), tag,
                                    self.optimizer, step=self.step)

    def load(self, path: str) -> None:
        """Load a weights folder written by `save` (with its optimizer
        state), or JAX refine variables flattened into a `.npz` (a folder
        holding `variables.npz`, as `scripts/convert_checkpoint.py` writes
        it, or the file)."""
        meta = ckpt.load_checkpoint(path, self._bundle(), self.optimizer)
        self.step = int(meta.get("step", self.step))

