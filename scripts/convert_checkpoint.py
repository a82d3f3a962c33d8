"""Convert checkpoints between the JAX package (fusiondepth_tpu, orbax) and
the PyTorch port (fusiondepth_torch).

    python scripts/convert_checkpoint.py to-port SRC DST
    python scripts/convert_checkpoint.py to-jax SRC DST

to-port: SRC is a JAX weights folder, either a stage-1 checkpoint (orbax
{params, batch_stats, opt_state} and meta.json, written by
fusiondepth_tpu/training/checkpoint.py::save_checkpoint) or a refiner
bundle (orbax {refine_params, opt_state} and, under train_entire_net,
stage1_variables, written by fusiondepth_tpu/training/refiner_driver.py::
Refiner.save). DST receives variables.npz, the variables flattened as
fusiondepth_torch/models/jax_weights.py::flatten lays them out (a refiner
bundle's decoder under "refine2d", its stage-1 nets under their own
names), and SRC's meta.json where it has one. The port's load_checkpoint,
every port entry point that takes a weights folder, and the port's
Refiner.load read DST.

to-jax: SRC is a port stage-1 weights folder (model.pt and meta.json,
written by fusiondepth_torch/training/checkpoint.py::save_checkpoint).
DST becomes an orbax checkpoint with meta.json that
fusiondepth_tpu/training/checkpoint.py::load_checkpoint restores: the
parameters and BN statistics through jax_weights.to_jax_variables, and as
opt_state the JAX package's own fresh make_optimizer state, its schedule
count at meta.json's step.

Not carried in either direction: the Adam moments. A converted checkpoint
resumes with fresh first and second moments (to-port writes no
optimizer.pt; to-jax writes zeros and an Adam count of 0).

Runs on the CPU and needs JAX, flax and orbax, which the card's machine
of the port does not have: convert on a machine with the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

JAX_FILE = "variables.npz"
META_FILE = "meta.json"
MODEL_FILE = "model.pt"


def _restore(path: str):
    """The orbax tree at `path` as numpy arrays, restored on the CPU from
    the checkpoint's own metadata (no template is needed)."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path)
    meta = getattr(meta, "item_metadata", meta)  # orbax's StepMetadata
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    with jax.enable_x64():  # float64 checkpoints restore as float64
        target = jax.tree.map(
            lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu),
            getattr(meta, "tree", meta),
            is_leaf=lambda m: hasattr(m, "shape"))
        return jax.tree.map(np.asarray, ckptr.restore(path, target))


def jax_to_port(src: str, dst: str) -> str:
    """JAX stage-1 checkpoint or refiner bundle -> variables.npz (+
    meta.json) in `dst`; returns the path of the .npz."""
    from fusiondepth_torch.models.jax_weights import NETS, flatten

    src = os.path.abspath(src)
    tree = _restore(src)
    if "refine_params" in tree:
        variables = {"refine2d": tree["refine_params"]}
        variables.update(tree.get("stage1_variables") or {})
    else:
        variables = {}
        for net, params in tree["params"].items():
            v = {"params": params}
            if tree["batch_stats"].get(net):
                v["batch_stats"] = tree["batch_stats"][net]
            variables[net] = v
    unknown = set(variables) - set(NETS)
    if unknown:
        raise KeyError(f"{src}: nets {sorted(unknown)} have no port "
                       "counterpart")
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(dst, JAX_FILE)
    np.savez(out, **flatten(variables))
    if os.path.exists(os.path.join(src, META_FILE)):
        shutil.copy(os.path.join(src, META_FILE),
                    os.path.join(dst, META_FILE))
    return out


def port_to_jax(src: str, dst: str) -> str:
    """Port stage-1 weights folder -> orbax checkpoint + meta.json at
    `dst`; returns `dst`."""
    import jax
    import orbax.checkpoint as ocp
    import torch

    from fusiondepth_torch.models.jax_weights import to_jax_variables
    from fusiondepth_tpu.config import Config as JaxConfig
    from fusiondepth_tpu.training.train_state import make_optimizer

    src, dst = os.path.abspath(src), os.path.abspath(dst)
    meta = {}
    if os.path.exists(os.path.join(src, META_FILE)):
        with open(os.path.join(src, META_FILE)) as f:
            meta = json.load(f)
    sd = torch.load(os.path.join(src, MODEL_FILE), map_location="cpu",
                    weights_only=True)
    variables = to_jax_variables(sd)
    params = {k: v["params"] for k, v in variables.items()}
    stats = {k: v.get("batch_stats", {}) for k, v in variables.items()}
    with jax.enable_x64(any(a.dtype == np.float64
                            for a in jax.tree.leaves(params))):
        # the fresh state of make_optimizer (zero moments, counts 0), made
        # in numpy from its shapes; the schedule's count at the saved step,
        # so that the learning rate resumes where it was
        adam, schedule = jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype),
            jax.eval_shape(make_optimizer(JaxConfig(), 1).init, params))
        opt_state = (adam, schedule._replace(count=np.asarray(
            meta.get("step", 0), np.int32)))
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(dst, {"params": params, "batch_stats": stats,
                         "opt_state": opt_state}, force=True)
        ckptr.wait_until_finished()
    with open(os.path.join(dst, META_FILE), "w") as f:
        json.dump(meta, f)
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Not carried in either direction: the Adam moments (a "
        "converted checkpoint resumes with fresh moments). Needs JAX and "
        "orbax; runs on the CPU.")
    p.add_argument("direction", choices=("to-port", "to-jax"),
                   help="to-port: a JAX stage-1 checkpoint or refiner "
                   "bundle to variables.npz; to-jax: a port weights folder "
                   "(model.pt) to an orbax checkpoint")
    p.add_argument("src", help="the weights folder to convert")
    p.add_argument("dst", help="the folder to write")
    args = p.parse_args(argv)
    if args.direction == "to-port":
        print(jax_to_port(args.src, args.dst))
    else:
        print(port_to_jax(args.src, args.dst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
