"""Carry weights between the JAX package's variable trees and the port's
state dicts, both ways, for the depth and pose networks.

A JAX FusionNets tree is `{net: {"params": ..., "batch_stats": ...}}`,
nested dicts of arrays; this module needs only numpy. The nets covered are
`encoder`, `beam_encoder`, `depth`, `predictive_mask`, `pose_encoder`,
`beam_encoder_pose` and `pose` (the PoseDecoder, or PoseCNN), the
refiner's `refine2d` decoder (its JAX variables `{"params": ...}` under
that key) and the sparse-3D refiner's voxel net under `refine3d` (the
JAX Refiner3D's `net_variables`); other subtrees are skipped. The trees
the JAX package builds with its default TPU layout flags have the
generic layout's names and shapes, so they carry over unchanged.

Mapping, JAX -> port:
  kernel (H, W, I, O)        -> weight (O, I, H, W)
  voxel kernel (27 I, O)     -> weight (27 I, O), unchanged
  BatchNorm scale / bias     -> weight / bias
  batch_stats mean / var     -> running_mean / running_var
  encoder layer{s}_{b}       -> layer{s}.{b}
  downsample_conv / _bn      -> downsample.0 / downsample.1
Decoder module names (`upconv_4_0/conv`, `dispconv_0/conv`, and with
`deep` `upconv_4_0/a/conv`, `upconv_4_0/b/conv`), pose decoder ones
(`squeeze`, `pose_0`..`pose_2`) and PoseCNN ones (`conv_0`..`conv_6`,
`pose_conv`: HWIO kernels and biases) and the voxel nets' ones
(`conv{i}`, `bn{i}`, `head`, `enc{l}_conv`, `enc{l}_bn`, `dec{l}_conv`,
`dec{l}_bn`) are the same.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

NETS = ("encoder", "beam_encoder", "depth", "predictive_mask",
        "pose_encoder", "beam_encoder_pose", "pose", "refine2d", "refine3d")

_BLOCK = re.compile(r"^layer(\d+)_(\d+)$")
_MODULE_TO_TORCH = {"downsample_conv": "downsample.0",
                    "downsample_bn": "downsample.1"}
_MODULE_TO_JAX = {v: k for k, v in _MODULE_TO_TORCH.items()}
_LEAF_TO_TORCH = {("params", "kernel"): "weight",
                  ("params", "scale"): "weight",
                  ("params", "bias"): "bias",
                  ("batch_stats", "mean"): "running_mean",
                  ("batch_stats", "var"): "running_var"}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _module_to_torch(name: str) -> str:
    m = _BLOCK.match(name)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    return _MODULE_TO_TORCH.get(name, name)


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX FusionNets variables -> the port's FusionNets state dict (CPU
    tensors in the arrays' dtype; `load_state_dict` casts and moves)."""
    sd = {}
    for net in NETS:
        if net not in variables:
            continue
        for path, leaf in _walk(variables[net]):
            collection, modules, name = path[0], path[1:-1], path[-1]
            arr = np.asarray(leaf)
            if name == "kernel" and arr.ndim == 4:
                arr = np.transpose(arr, (3, 2, 0, 1))
            key = ".".join((net, *map(_module_to_torch, modules),
                            _LEAF_TO_TORCH[(collection, name)]))
            sd[key] = torch.tensor(arr)  # a copy: JAX buffers are read-only
    return sd


def to_jax_variables(state_dict: Dict[str, torch.Tensor]
                     ) -> Dict[str, Any]:
    """Inverse of from_jax_variables: numpy arrays in nested dicts."""
    out: Dict[str, Any] = {}
    for key, t in state_dict.items():
        net, rest = key.split(".", 1)
        if net not in NETS:
            continue
        parts = rest.split(".")
        leaf = parts.pop()
        modules = []
        while parts:
            p = parts.pop(0)
            if p.startswith("layer") and parts and parts[0].isdigit():
                p = f"{p}_{parts.pop(0)}"
            elif p == "downsample":
                p = _MODULE_TO_JAX[f"{p}.{parts.pop(0)}"]
            modules.append(p)
        arr = t.detach().cpu().numpy()
        if leaf == "running_mean":
            collection, name = "batch_stats", "mean"
        elif leaf == "running_var":
            collection, name = "batch_stats", "var"
        elif leaf == "weight" and arr.ndim == 4:
            collection, name = "params", "kernel"
            arr = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))
        elif leaf == "weight" and arr.ndim == 2:
            collection, name = "params", "kernel"
        elif leaf == "weight":
            collection, name = "params", "scale"
        else:
            collection, name = "params", leaf
        node = out.setdefault(net, {}).setdefault(collection, {})
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = arr
    return out


def flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested variables -> {"encoder/params/conv1/kernel": array}, the
    layout of a `.npz` of JAX variables (`training/checkpoint.py`)."""
    return {"/".join(p): np.asarray(v) for p, v in _walk(tree)}


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, name = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = v
    return out
