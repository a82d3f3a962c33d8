"""Checkpoints of the port, laid out as the JAX package lays out its own
(`fusiondepth_tpu/training/checkpoint.py`):

  {log_dir}/{model_name}/models/opt.json             the run's Config
  {log_dir}/{model_name}/models/weights_{tag}/
      model.pt     torch.save of the FusionNets state_dict
      meta.json    height, width, use_stereo, num_layers

`load_checkpoint` also takes JAX variables flattened into a `.npz`
(keys like "encoder/params/conv1/kernel", `models/jax_weights.flatten`),
either the file itself or a weights folder holding `variables.npz`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fusiondepth_tpu.config import Config
from fusiondepth_torch.models import jax_weights

MODEL_FILE = "model.pt"
JAX_FILE = "variables.npz"


def _ckpt_dir(log_dir: str, model_name: str, tag: str) -> str:
    return os.path.abspath(
        os.path.join(log_dir, model_name, "models", f"weights_{tag}"))


def save_options(cfg: Config) -> None:
    d = os.path.join(cfg.log_dir, cfg.model_name, "models")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "opt.json"), "w") as f:
        f.write(cfg.to_json())


def save_checkpoint(cfg: Config, nets: torch.nn.Module, tag: str) -> str:
    path = _ckpt_dir(cfg.log_dir, cfg.model_name, tag)
    os.makedirs(path, exist_ok=True)
    torch.save(nets.state_dict(), os.path.join(path, MODEL_FILE))
    meta = {"height": cfg.height, "width": cfg.width,
            "use_stereo": cfg.use_stereo, "num_layers": cfg.num_layers}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, nets: torch.nn.Module) -> dict:
    """Load weights into `nets` in place; returns the meta dict (empty when
    there is none). Every tensor of `nets` must be in the checkpoint."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, MODEL_FILE)):
            src = os.path.join(path, MODEL_FILE)
        elif os.path.exists(os.path.join(path, JAX_FILE)):
            src = os.path.join(path, JAX_FILE)
        else:
            raise FileNotFoundError(
                f"{path} holds neither {MODEL_FILE} nor {JAX_FILE}")
        meta_path = os.path.join(path, "meta.json")
    else:
        src, meta_path = path, None
    if src.endswith(".npz"):
        with np.load(src) as z:
            flat = {k: z[k] for k in z.files}
        sd = jax_weights.from_jax_variables(jax_weights.unflatten(flat))
    else:
        sd = torch.load(src, map_location="cpu", weights_only=True)
    nets.load_state_dict(sd)
    meta = {}
    if meta_path and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return meta
