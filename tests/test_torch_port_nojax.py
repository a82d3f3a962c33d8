"""The port must run where JAX is not installed: importing every module of
fusiondepth_torch (stage 2 included: gdc, the KNN and reprojection
kernels, the refiner and its drivers, completion and the bench), its
CLIs (the trainer, inference, evaluation, inf_gdc, refiner, completor,
evaluate_completion, gen2cha_completion, export_detection and bench) and
chip_smoke.py loads no module of
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
    assert int(n) >= 65, r.stdout  # every module of the port was imported
    assert verdict == "clean", r.stdout
