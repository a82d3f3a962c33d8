"""Stage-1 self-supervised trainer driver (counterpart of
`fusiondepth_tpu/training/trainer.py`; reference trainer.py:24-266 and its
val protocol :390-423).

Schedule semantics of the reference:
  num_epochs   = (8 * 17) // batch_size
  lr           = learning_rate * batch_size / 8
  StepLR step  = scheduler_step_size * 8 / batch_size (gamma 0.1)
and validation on the eigen test split after every epoch, with
best-AbsRel checkpointing.

Runs on one card (cuda:0 unless `device` names another; device="cpu" for
the tests) in the config's dtype, float32 by default with TF32 off, so
that float32 means float32 in cuDNN's convolutions too. Data-parallel
over processes (`use_mesh`, or a process group of several ranks,
`parallel/`), as the JAX trainer shards over its mesh: each rank runs on
its card (cuda:LOCAL_RANK unless `device` names one), loads its W-th of
the global batch (`local_batch_size`) from its slice of the split
(`shard_lines`; a dataset handed in is strided the same way,
`RankShard`), and steps with the batch-global statistics, SI loss and
gradient all-reduce of `training/train_state.py`. The nets start equal on
every rank (`broadcast_module` after init, pretrained weights or a
resume); only rank 0 writes the options and checkpoints. Every rank
validates on the whole val split, as in JAX. steps_per_epoch is the JAX
package's: the local dataset's length over the global batch. The host feed
runs ahead of the step in a thread (data/prefetch.py) with pinned,
non-blocking uploads; losses are read back only every log_frequency steps.
Every stage-1 training variant of the JAX package trains here
(v1_multiscale, use_stereo, predictive_mask, the posecnn and shared pose
types, pose_model_input="all") and remat, on one card or several.
compute_dtype="bfloat16" trains the default step in bf16 over float32
parameters, BN statistics and Adam state (the variants and remat refuse
it). With save_sample or
visualize, `validate` logs the first batch's frame-0 disparity and colour
image (PNGs next to the metrics), as the JAX trainer does.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.data.prefetch import prefetch_to_device
from fusiondepth_torch.models.fusion import FusionNets, model_dtype
from fusiondepth_torch.models.pretrained import apply_pretrained
from fusiondepth_torch.parallel import (
    barrier,
    broadcast_module,
    default_device,
    local_batch_size,
    make_mesh,
    process_count,
    process_index,
    shard_lines,
)
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.evaluation import evaluate_disparities
from fusiondepth_torch.training.infer_driver import (
    DEPTH_KEYS,
    device_batch,
    resolve_device,
)
from fusiondepth_torch.training.train_state import (
    check_train_supported,
    make_optimizer,
    train_step,
)
from fusiondepth_torch.utils.logging import MetricLogger, sec_to_hm_str

TRAIN_KEYS = ("color", "color_aug", "two_channel", "four_beam", "K",
              "inv_K", "stereo_T")


class RankShard:
    """Rank `rank`'s strided slice of a dataset of `world` ranks: the
    samples `shard_lines` would give it of the dataset's lines."""

    def __init__(self, dataset, rank: int, world: int):
        self.dataset = dataset
        self.index = shard_lines(range(len(dataset)), rank, world)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        return self.dataset[self.index[i]]


class Trainer:
    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 device=None, use_mesh: Optional[bool] = None):
        cfg = cfg.replace(num_epochs=max((8 * 17) // cfg.batch_size, 1))
        if cfg.use_stereo and "s" not in cfg.frame_ids:
            # stereo adds the opposite-side frame (reference
            # trainer.py:63-64)
            cfg = cfg.replace(frame_ids=tuple(cfg.frame_ids) + ("s",))
        if cfg.height % 32 or cfg.width % 32:
            raise ValueError("height/width must be multiples of 32")
        check_train_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device if device is not None
                                     else default_device())
        # data parallelism: cfg.use_mesh / cfg.mesh_shape (the ctor arg
        # overrides), or several processes; one process per card, each
        # holding its W-th of the global batch
        if use_mesh is None:
            use_mesh = cfg.use_mesh
        self.process_count = process_count()
        self.is_lead_host = process_index() == 0
        self.mesh = (make_mesh(cfg.mesh_shape, self.device)
                     if use_mesh or self.process_count > 1 else None)
        self.group = None if self.mesh is None else self.mesh.group
        if self.mesh is not None:
            n_data = self.mesh.shape["data"]
            if cfg.batch_size % n_data:
                raise ValueError(
                    f"batch_size {cfg.batch_size} not divisible by the "
                    f"mesh's data axis ({n_data} ranks)")
            if cfg.batch_size % (n_data * max(cfg.grad_accum_steps, 1)):
                raise NotImplementedError(
                    f"batch_size {cfg.batch_size} over {n_data} ranks x "
                    f"{cfg.grad_accum_steps} microbatches: each rank's "
                    "microbatches must split the global ones evenly (the "
                    "JAX package reshards; ROADMAP.md §1)")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = model_dtype(cfg)

        self.nets = FusionNets(cfg, device=self.device,
                               generator=torch.Generator().manual_seed(
                                   cfg.seed))
        if cfg.weights_init == "pretrained":
            apply_pretrained(cfg, self.nets)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        if train_dataset is None and cfg.dataset in ("kitti", "kitti_odom"):
            self._build_kitti_datasets()
        elif train_dataset is not None and self.process_count > 1:
            self.train_dataset = RankShard(train_dataset, process_index(),
                                           self.process_count)

        steps_per_epoch = (
            max(len(self.train_dataset) // cfg.batch_size, 1)
            if self.train_dataset is not None else 1000)
        self.optimizer, self.scheduler = make_optimizer(
            cfg, self.nets, steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)
        # rank 0 logs under log_path, every other rank under rank<r>/
        log_path = self.log_path if self.is_lead_host else os.path.join(
            self.log_path, f"rank{process_index()}")
        self.loggers = {mode: MetricLogger(log_path, mode, use_tb=False)
                        for mode in ("train", "val")}
        self.loggers["train"].add_watch("loss", "nan",
                                        title="non-finite training loss")
        if self.is_lead_host:
            ckpt.save_options(cfg)

        self.step = 0
        if cfg.train_load_weights_folder:
            # resume restricted to --models_to_load, with the beam encoders
            # appended when they exist (reference trainer.py:725-730)
            to_load = list(cfg.models_to_load)
            if cfg.beam_encoder:
                to_load += ["beam_encoder", "beam_encoder_pose"]
            meta = ckpt.load_checkpoint(
                cfg.train_load_weights_folder, self.nets, self.optimizer,
                self.scheduler, models_to_load=to_load)
            self.step = int(meta.get("step", 0))
        broadcast_module(self.nets, self.group)
        self.best_absrel = float("inf")
        self.epoch = 0
        self._t_start = time.time()

    # ---- data ----

    def _build_kitti_datasets(self):
        from fusiondepth_torch.data.kitti_dataset import (
            KITTIOdomDataset,
            KITTIRAWDataset,
        )
        from fusiondepth_torch.data.kitti_io import readlines

        cfg = self.cfg
        cls = (KITTIOdomDataset if cfg.dataset == "kitti_odom"
               else KITTIRAWDataset)
        split_dir = os.path.join(os.path.dirname(__file__), "..", "..",
                                 "splits")
        # each process reads a disjoint strided slice of the split
        # (parallel/multihost.py); single-process this is identity
        train_files = shard_lines(readlines(
            os.path.join(split_dir, cfg.split, "train_files.txt")))
        test_files = readlines(
            os.path.join(split_dir, "eigen", "test_files.txt"))
        ext = ".png" if cfg.png else ".jpg"
        self.train_dataset = cls(cfg.data_path, train_files, cfg.height,
                                 cfg.width, cfg.frame_ids, is_train=True,
                                 img_ext=ext, cfg=cfg)
        # reference quirk kept on purpose: the val loader IS the eigen test
        # split (trainer.py:161-171)
        self.val_dataset = cls(cfg.data_path, test_files, cfg.height,
                               cfg.width, [0], is_train=False, img_ext=ext,
                               cfg=cfg)

    def _loader(self, dataset, shuffle: bool):
        # cfg.batch_size is the GLOBAL batch; each process loads its share
        bs = local_batch_size(self.cfg.batch_size, self.process_count)
        return DataLoader(dataset, bs, shuffle=shuffle,
                          drop_last=shuffle, num_workers=self.cfg.num_workers)

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> the step's inputs on the card, in the model dtype."""
        return device_batch(batch, self.device, TRAIN_KEYS, self.dtype)

    # ---- training ----

    def run_step(self, batch, on_device: bool = False,
                 noise=None) -> Dict[str, torch.Tensor]:
        """One train step on this rank's batch; returns the global batch's
        losses (tensors on the card). `noise` replays the automask noise
        (`train_step`)."""
        db = batch if on_device else self.put_batch(batch)
        losses = train_step(self.cfg, self.nets, self.optimizer,
                            self.scheduler, db, generator=self.generator,
                            noise=noise, group=self.group)
        self.step += 1
        return losses

    def run_epoch(self) -> List[torch.Tensor]:
        """One pass over the train split; returns each step's loss."""
        cfg = self.cfg
        loader = self._loader(self.train_dataset, shuffle=True)
        t_last, n_last = time.time(), 0
        step_losses = []
        for db in prefetch_to_device(loader, self.put_batch, size=2):
            losses = self.run_step(db, on_device=True)
            step_losses.append(losses["loss"])
            n_last += cfg.batch_size
            if self.step % cfg.log_frequency == 0:
                loss = float(losses["loss"])  # the sync point
                dt = time.time() - t_last
                eps = n_last / max(dt, 1e-9)
                if self.is_lead_host:
                    print(f"epoch {self.epoch:3d} | step {self.step:6d} | "
                          f"loss {loss:.4f} | {eps:7.1f} ex/s | elapsed "
                          f"{sec_to_hm_str(time.time() - self._t_start)}",
                          flush=True)
                self.loggers["train"].log_scalars(
                    self.step, {"loss": loss, "examples_per_sec": eps})
                t_last, n_last = time.time(), 0
        return step_losses

    def save(self, tag: str) -> str:
        """Rank 0 writes the checkpoint; every rank waits for it and gets
        its path."""
        path = ckpt.checkpoint_dir(self.cfg, tag)
        if self.is_lead_host:
            ckpt.save_checkpoint(self.cfg, self.nets, tag, self.optimizer,
                                 self.scheduler, self.step)
        barrier(self.group, self.device)
        return path

    def train(self) -> None:
        for self.epoch in range(self.cfg.num_epochs):
            self.run_epoch()
            metrics = self.validate()
            if metrics and self.cfg.save_frequency > 0:
                self.save(f"{self.epoch}")

    # ---- validation (eigen protocol) ----

    def validate(self) -> Optional[Dict[str, float]]:
        if self.val_dataset is None:
            return None
        loader = self._loader(self.val_dataset, shuffle=False)
        disps, gts = [], []
        sample_logged = False
        with torch.inference_mode():
            for batch in loader:
                db = device_batch(batch, self.device, DEPTH_KEYS)
                out = self.nets.forward_depth(db, train=False)[0]
                disp = out[("disp", 0)][..., 0].float().cpu().numpy()
                disps.extend(disp)
                gts.extend(batch.get("depth_gt", []))
                if (self.cfg.save_sample or self.cfg.visualize) \
                        and not sample_logged:
                    # the first batch's frame 0, as the JAX trainer logs it
                    d = disp[0]
                    self.loggers["val"].log_image(
                        self.step, "disp_0", d / max(float(d.max()), 1e-9))
                    self.loggers["val"].log_image(
                        self.step, "color_0", np.asarray(batch["color"])[0, 0])
                    sample_logged = True
        if not gts:
            return None
        metrics = evaluate_disparities(disps, gts)
        self.loggers["val"].log_scalars(self.step, metrics)
        if self.is_lead_host:
            print("val | " + " | ".join(
                f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
        if metrics["abs_rel"] < self.best_absrel:
            self.best_absrel = metrics["abs_rel"]
            self.save("best")
            self.save(f"absrel{int(metrics['abs_rel'] * 1e5)}")
        return metrics

