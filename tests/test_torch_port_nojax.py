"""The port must run where JAX is not installed: importing every module of
fusiondepth_torch (stage 2 included: gdc, the KNN and reprojection
kernels, the refiner and its drivers, the sparse-3D refiner and its
voxel nets, completion and the bench), its
CLIs (the trainer, inference, evaluation, inf_gdc, refiner, completor,
evaluate_completion, gen2cha_completion, export_detection, bench and the
host data-prep CLIs sparsify, gen2channel, gen2channel_detec and
export_gt_depth), the pose nets, ops/sampling.py and ops/losses.py, the
data-parallel modules (fusiondepth_torch.parallel.* and the multichip dry
run), and chip_smoke.py loads no module of
jax, jaxlib, flax or the JAX package (fusiondepth_tpu). Checked in a
fresh interpreter, since this test process has imported JAX already
(tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import fusiondepth_torch
mods = [m.name for m in pkgutil.walk_packages(fusiondepth_torch.__path__,
                                              "fusiondepth_torch.")]
for m in mods:
    importlib.import_module(m)
import fusiondepth_torch.trainer
import fusiondepth_torch.inf_depth_map
import fusiondepth_torch.evaluate_depth
import fusiondepth_torch.inf_gdc
import fusiondepth_torch.refiner
import fusiondepth_torch.training.trainer
import fusiondepth_torch.training.refiner_driver
import fusiondepth_torch.training.refiner3d
import fusiondepth_torch.models.refine_net3d
import fusiondepth_torch.training.gdc_driver
import fusiondepth_torch.gdc.gdc
import fusiondepth_torch.kernels.knn
import fusiondepth_torch.kernels.reproj
import fusiondepth_torch.training.completor
import fusiondepth_torch.data.completion_dataset
import fusiondepth_torch.bench
import fusiondepth_torch.completor
import fusiondepth_torch.evaluate_completion
import fusiondepth_torch.gen2cha_completion
import fusiondepth_torch.export_detection
import fusiondepth_torch.sparsify
import fusiondepth_torch.gen2channel
import fusiondepth_torch.gen2channel_detec
import fusiondepth_torch.export_gt_depth
import fusiondepth_torch.models.pose
import fusiondepth_torch.ops.sampling
import fusiondepth_torch.ops.losses
import fusiondepth_torch.parallel
import fusiondepth_torch.parallel.collectives
import fusiondepth_torch.parallel.mesh
import fusiondepth_torch.parallel.multihost
import fusiondepth_torch.multichip
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "fusiondepth_tpu"))
print(len(mods), ",".join(bad) or "clean")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, verdict = r.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 67, r.stdout  # every module of the port was imported
    assert verdict == "clean", r.stdout
