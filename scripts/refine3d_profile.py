"""Where the time of one Refiner3D step goes, on one NVIDIA GPU.

    python3 scripts/refine3d_profile.py [--net refineUnet] [--steps 2]
        [--out log/refine3d_profile.txt]

Builds the sparse-3D refiner with `chip_smoke.py`'s refine3d setup
(`refine3d_setup`, `refine3d_refiner`: the ResNet-18 stage 1 at 640x192
with its seeded weights and shifted disparity head, the voxel net the
selector `--net` names at 0.5 m and 16384 voxels a sample) on a batch of
4 synthetic frames carrying a GDC target; fp32, TF32 off. Runs two warm-up
steps, times one step on the host clock around a synchronized step, then
profiles `--steps` steps with torch.profiler and prints one JSON line: the
card, the wall ms of a step, the device time and the kernel launches a
step, and the operators with the most device time. The profiler's tables
go to `--out`. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fusiondepth_torch.data.loader import collate  # noqa: E402
from fusiondepth_torch.kernels import build  # noqa: E402
from fusiondepth_torch.training.refiner3d import SELECTORS  # noqa: E402


def device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", choices=SELECTORS, default="refineUnet")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="log/refine3d_profile.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refine3d_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    build.load()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, data = cs.refine3d_setup(tmp, cs.REFINE_BATCH)
        r = cs.refine3d_refiner(cfg, args.net, data, dev)
        batch = r.put_batch(collate([data[i] for i in range(len(data))]))
        for _ in range(2):
            r.run_step(batch, on_device=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.run_step(batch, on_device=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                r.run_step(batch, on_device=True)
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if device_us(e) > 0 and e.device_type
               == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for key in ("self_cuda_time_total", "cpu_time_total"):
            f.write(events.table(sort_by=key, row_limit=40,
                                 max_name_column_width=80) + "\n")
    print(json.dumps({
        "card": cs.card_line(), "net": args.net,
        "batch": cs.REFINE_BATCH, "wall_ms": wall_ms,
        "device_ms_per_step": sum(device_us(e) for e in kernels) / 1e3
        / args.steps,
        "launches_per_step": launches / args.steps,
        "top_kernels_ms_per_step": {e.key[:80]: device_us(e) / 1e3
                                    / args.steps for e in top}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
