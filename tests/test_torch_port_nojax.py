"""The port must run where JAX is not installed: importing it, its drivers,
its entry points and chip_smoke.py pulls in neither jax nor flax. Checked
in a fresh interpreter, since this test process has imported JAX already
(tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import fusiondepth_torch
import fusiondepth_torch.kernels.build
import fusiondepth_torch.kernels.conv3x3
import fusiondepth_torch.kernels.pool
import fusiondepth_torch.models.fusion
import fusiondepth_torch.models.jax_weights
import fusiondepth_torch.models.pretrained
import fusiondepth_torch.training.checkpoint
import fusiondepth_torch.training.eval_driver
import fusiondepth_torch.training.infer_driver
import fusiondepth_torch.inf_depth_map
import fusiondepth_torch.evaluate_depth
import fusiondepth_tpu.data.kitti_dataset
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(",".join(bad) or "clean")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "clean", r.stdout
