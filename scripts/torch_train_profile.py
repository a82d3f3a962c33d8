"""Where the time of one port train step goes, on one NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--config 3] [--batch N]
        [--steps 3] [--set KEY=VALUE ...] [--out log/train_profile.json]

Builds the port's trainer for BASELINE config 3 (ResNet-18, 640x192,
batch 12) or, with --config 5, its completor (ResNet-50 depth and beam
encoders, ResNet-18 pose encoders, 1216x352, batch 4), fp32, TF32 off,
random weights from a seed, with the Config fields given by `--set`
(e.g. `--set v1_multiscale=true --set use_stereo=true --set
pose_model_type=posecnn`: a training variant; the value parsed as JSON
when it can be; use_stereo adds the frame "s" as the Trainer does), runs
two warm-up steps, then
`--steps` steps under torch.profiler, and prints one JSON line: the card,
the wall ms per step (host clock around a synchronized step, without the
profiler), the device-busy ms per step (union of kernel intervals), and
the device time per step grouped into the port's hand-written kernels,
cuDNN convolutions, the optimizer, and the rest, with the top kernels by
name. The full table goes to `--out`. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from fusiondepth_torch.bench import parse_set  # noqa: E402
from fusiondepth_torch.config import Config  # noqa: E402
from fusiondepth_torch.data.loader import collate  # noqa: E402
from fusiondepth_torch.data.synthetic import SyntheticDataset  # noqa: E402
from fusiondepth_torch.kernels import build  # noqa: E402
from fusiondepth_torch.training.completor import Completor  # noqa: E402
from fusiondepth_torch.training.trainer import Trainer  # noqa: E402


def port_kernel_names() -> set:
    """The names of the `__global__` kernels of the port's CUDA sources
    (`__launch_bounds__(...)` between `void` and the name skipped)."""
    found = set()
    for src in build.CSRC.glob("*.cu"):
        found.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\(.*?\)\s*)?"
            r"(\w+)\s*\(", src.read_text()))
    return found


PORT_KERNELS = tuple(sorted(port_kernel_names()))


def group(name: str) -> str:
    """The group of a profiled kernel by its name: the port's own kernels
    first, since "conv" would file the hand convs under cuDNN."""
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "implicit", "sm90", "sm80",
                              "xmma", "wgrad", "dgrad", "fft", "complex",
                              "region_transform")):
        return "cuDNN convolutions"
    if "gemm" in low:
        return "cuBLAS (small matmuls)"
    if "adam" in low or "foreach" in low:
        return "optimizer"
    return "other (elementwise, reductions, copies)"


def busy_ms(events) -> float:
    """Union of the device intervals of the profiled kernels, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3, choices=[3, 5],
                    help="3: the stage-1 train step; 5: the completion "
                         "step")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 12 (config 3) or 4 (config 5)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="override a Config field")
    ap.add_argument("--out", default="log/train_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.batch is None:
        args.batch = 12 if args.config == 3 else 4
    overrides = parse_set(args.set)
    with tempfile.TemporaryDirectory() as tmp:
        if args.config == 3:
            cfg = Config(**{**dict(num_layers=18, height=192, width=640,
                                   weights_init="scratch"), **overrides,
                            "batch_size": args.batch, "log_dir": tmp})
            if cfg.use_stereo and "s" not in cfg.frame_ids:
                # the frames the Trainer trains on, which the data carry
                cfg = cfg.replace(frame_ids=tuple(cfg.frame_ids) + ("s",))
            data = SyntheticDataset(cfg, length=args.batch, seed=0)
            driver = Trainer(cfg, train_dataset=data, device=dev)
        else:
            cfg = Config(**{**dict(num_layers=50, completion_num_layers=50,
                                   completion_pose_num_layers=18,
                                   height=352, width=1216,
                                   weights_init="scratch"), **overrides,
                            "batch_size": args.batch, "log_dir": tmp})
            data = SyntheticDataset(cfg, length=args.batch, seed=0)
            driver = Completor(cfg, train_dataset=data, device=dev)
        batch = driver.put_batch(collate([data[i]
                                          for i in range(args.batch)]))
        for _ in range(2):
            driver.run_step(batch, on_device=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.steps):
            driver.run_step(batch, on_device=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                driver.run_step(batch, on_device=True)
            torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev_events:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / args.steps
        by_name[e.name][1] += 1
    groups = {}
    for name, (ms, _) in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "per_step": {n: {"ms": v[0],
                                                   "launches": v[1] /
                                                   args.steps}
                                               for n, v in top}}, f,
                  indent=1)
    print(json.dumps({
        "card": card, "config": args.config, "batch": args.batch,
        "set": overrides,
        "steps": args.steps,
        "wall_ms_per_step": wall,
        "device_busy_ms_per_step": busy_ms(dev_events) / args.steps,
        "device_launches_per_step": len(dev_events) / args.steps,
        "groups_ms_per_step": groups,
        "top": [[n[:80], round(v[0], 4), v[1] // args.steps]
                for n, v in top[:15]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
