"""Checkpoints of the port, laid out as the JAX package lays out its own
(`fusiondepth_tpu/training/checkpoint.py`):

  {log_dir}/{model_name}/models/opt.json             the run's Config
  {log_dir}/{model_name}/models/weights_{tag}/
      model.pt      torch.save of the FusionNets state_dict (every net)
      optimizer.pt  the optimizer's and the LR schedule's state_dicts,
                    when saved by the trainer
      meta.json     height, width, use_stereo, num_layers, step

`load_checkpoint` also takes JAX variables flattened into a `.npz`
(keys like "encoder/params/conv1/kernel", `models/jax_weights.flatten`),
either the file itself or a weights folder holding `variables.npz`.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.models import jax_weights

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
JAX_FILE = "variables.npz"


def _ckpt_dir(log_dir: str, model_name: str, tag: str) -> str:
    return os.path.abspath(
        os.path.join(log_dir, model_name, "models", f"weights_{tag}"))


def save_options(cfg: Config) -> None:
    d = os.path.join(cfg.log_dir, cfg.model_name, "models")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "opt.json"), "w") as f:
        f.write(cfg.to_json())


def save_checkpoint(cfg: Config, nets: torch.nn.Module, tag: str,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None, step: int = 0) -> str:
    path = _ckpt_dir(cfg.log_dir, cfg.model_name, tag)
    os.makedirs(path, exist_ok=True)
    torch.save(nets.state_dict(), os.path.join(path, MODEL_FILE))
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(),
                    "scheduler": (None if scheduler is None
                                  else scheduler.state_dict())},
                   os.path.join(path, OPTIMIZER_FILE))
    meta = {"height": cfg.height, "width": cfg.width,
            "use_stereo": cfg.use_stereo, "num_layers": cfg.num_layers,
            "step": int(step)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, nets: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None,
                    models_to_load: Optional[Sequence[str]] = None) -> dict:
    """Load weights into `nets` in place; returns the meta dict (empty when
    there is none). Every tensor of `nets` must be in the checkpoint, or,
    with `models_to_load` (reference --models_to_load), every tensor of the
    named nets; the others keep their values. The optimizer (and schedule)
    state is restored when asked for, saved, and every net was loaded."""
    path = os.path.abspath(path)
    opt_path = None
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, MODEL_FILE)):
            src = os.path.join(path, MODEL_FILE)
        elif os.path.exists(os.path.join(path, JAX_FILE)):
            src = os.path.join(path, JAX_FILE)
        else:
            raise FileNotFoundError(
                f"{path} holds neither {MODEL_FILE} nor {JAX_FILE}")
        meta_path = os.path.join(path, "meta.json")
        opt_path = os.path.join(path, OPTIMIZER_FILE)
    else:
        src, meta_path = path, None
    if src.endswith(".npz"):
        with np.load(src) as z:
            flat = {k: z[k] for k in z.files}
        sd = jax_weights.from_jax_variables(jax_weights.unflatten(flat))
    else:
        sd = torch.load(src, map_location="cpu", weights_only=True)
    every_net = True
    if models_to_load is None:
        nets.load_state_dict(sd)
    else:
        sel = set(models_to_load)
        own = nets.state_dict()
        want = {k for k in own if k.split(".", 1)[0] in sel}
        missing = sorted(want - set(sd))
        if missing:
            raise KeyError(f"{src} lacks {missing[:5]}")
        nets.load_state_dict({**own, **{k: sd[k] for k in want}})
        every_net = {k.split(".", 1)[0] for k in own} <= sel
    if optimizer is not None and every_net and opt_path \
            and os.path.exists(opt_path):
        state = torch.load(opt_path, map_location="cpu", weights_only=True)
        optimizer.load_state_dict(state["optimizer"])
        if scheduler is not None and state["scheduler"] is not None:
            scheduler.load_state_dict(state["scheduler"])
    meta = {}
    if meta_path and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return meta
