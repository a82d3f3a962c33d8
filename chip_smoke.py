"""Smoke run of the PyTorch port (fusiondepth_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch; not JAX. In
order, it:

1. refuses to run without a card (exit code 1, no result printed);
2. turns TF32 off for the plain PyTorch comparisons;
3. builds the port's kernels from fusiondepth_torch/kernels/csrc;
4. holds every kernel against its plain version on the inputs the depth
   path really gives it (ResNet-18 at 640x192, batch 1, weights and
   BatchNorm statistics made from a seed), and on the edge cases of
   `edge_calls` (ties, NaN, odd and ragged sizes, a positive BN shift):
   the pool exactly, the convs at atol 1e-4, rtol 1e-4;
5. saves those weights as a checkpoint and drives the inference path
   through its entry points, which load it: Infer.run_split
   over 8 synthetic frames at batch 1, then predict_disparities with the
   flip post-process at batch 4, with the launch counts set to 0 before
   each and read after; checks the cached files and disparities, that
   every kernel ran, and that the forward through the kernels matches the
   same weights run all-plain on the card (atol 1e-4);
6. times each kernel against its plain version, and the whole forward
   against the all-plain one, with CUDA events after warm-up;
7. prints the card's name and power limit (nvidia-smi), then one JSON line
   {"kernels": [...]}, then, last, {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is not 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fusiondepth_tpu.config import Config
from fusiondepth_tpu.data.loader import collate
from fusiondepth_tpu.data.synthetic import SyntheticDataset
from fusiondepth_torch.kernels import LAUNCHES, build, conv3x3, pool, \
    reset_launches
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.norm import BatchNorm
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.eval_driver import predict_disparities
from fusiondepth_torch.training.infer_driver import Infer, device_batch

HEIGHT, WIDTH, FRAMES = 192, 640, 8
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
FORWARD_ATOL = 1e-4

# kernel -> (wrapper module, wrapper, plain version, source, TPU kernel)
KERNELS = {
    "maxpool3x3s2": (pool, "maxpool3x3s2", pool.maxpool3x3s2_plain,
                     "fusiondepth_torch/kernels/csrc/maxpool3x3s2.cu",
                     "fusiondepth_tpu/ops/pallas_pool.py:186"),
    "conv3x3_reflect": (conv3x3, "conv3x3_reflect",
                        conv3x3.conv3x3_reflect_plain,
                        "fusiondepth_torch/kernels/csrc/conv3x3.cu",
                        "fusiondepth_tpu/ops/pallas_fold_conv.py:370"),
    "conv3x3_zero_act": (conv3x3, "conv3x3_zero_act",
                         conv3x3.conv3x3_zero_act_plain,
                         "fusiondepth_torch/kernels/csrc/conv3x3.cu",
                         "fusiondepth_tpu/ops/pallas_fold_conv.py:370"),
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def plain_kernels(record=None):
    """Route every kernel wrapper to its plain version for the duration;
    with `record`, also append (kernel, args, kwargs) of each call, inputs
    cloned. Launches nothing."""
    saved = {}
    for name, (mod, attr, plain, _, _) in KERNELS.items():
        saved[name] = getattr(mod, attr)

        def stand_in(*args, _name=name, _plain=plain, **kwargs):
            if record is not None:
                record.append((_name, [a.clone() if torch.is_tensor(a)
                                       else a for a in args], dict(kwargs)))
            return _plain(*args, **kwargs)

        setattr(mod, attr, stand_in)
    try:
        yield
    finally:
        for name, (mod, attr, _, _, _) in KERNELS.items():
            setattr(mod, attr, saved[name])


class SmokeFrames:
    """Synthetic frames with the parse_line of a KITTI split."""

    def __init__(self, cfg: Config, n: int):
        self.inner = SyntheticDataset(cfg, length=n, seed=0)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return self.inner[i]

    def parse_line(self, i):
        return "2011_09_26/2011_09_26_drive_0001_sync", i, "l"


def seeded_weights(cfg: Config, seed: int = 0) -> FusionNets:
    """The model's own seeded init, with every BatchNorm's scale, shift and
    running statistics and every conv bias drawn from the seed as well, so
    that no affine is the identity (the fused encoder conv's border
    handling is only visible with a non-zero shift)."""
    nets = FusionNets(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in nets.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return nets


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, **kw):
    """(kernel ms, plain ms), timed in the order plain, kernel, kernel,
    plain so that drift on the card falls on both alike."""
    p1 = cuda_ms(plain_fn, **kw)
    k1 = cuda_ms(kernel_fn, **kw)
    k2 = cuda_ms(kernel_fn, **kw)
    p2 = cuda_ms(plain_fn, **kw)
    return (k1 + k2) / 2, (p1 + p2) / 2


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def edge_calls(dev):
    """Inputs the flagship forward does not give the kernels: a tied and a
    NaN pool input, odd pool sizes; convs with ragged tiles, channel counts
    that are no multiple of the kernel's channel tiles, a 2-channel second
    input (cat2end), the smallest maps, and a positive BN shift, whose
    relu must not leak into the zero pad."""
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    tied = torch.randint(0, 3, (1, 64, HEIGHT // 2, WIDTH // 2),
                         generator=g, device=dev).float()
    nan = randn(2, 3, 9, 9)
    nan[0, 1, 4, 4] = float("nan")
    calls = [("maxpool3x3s2", [x], {}) for x in
             (tied, nan, randn(2, 3, 7, 10), randn(1, 5, 1, 3))]
    for B, C0, C1, Co, H, W, elu in ((2, 13, 2, 5, 11, 37, True),
                                     (1, 16, 0, 1, 2, 2, False),
                                     (2, 24, 9, 20, 90, 300, True)):
        x1 = randn(B, C1, H, W) if C1 else None
        calls.append(("conv3x3_reflect",
                      [randn(B, C0, H, W), randn(Co, C0 + C1, 3, 3, scale=0.2),
                       randn(Co, scale=0.1), x1, elu], {}))
    for B, C, Co, H, W in ((2, 13, 7, 9, 33), (1, 4, 3, 1, 1),
                           (1, 64, 64, HEIGHT // 4, WIDTH // 4)):
        x, w = randn(B, C, H, W), randn(Co, C, 3, 3, scale=C ** -0.5 / 3)
        s = 0.5 + torch.rand(C, generator=g, device=dev)
        t = 0.2 + torch.rand(C, generator=g, device=dev)
        calls += [("conv3x3_zero_act", [x, w], {}),
                  ("conv3x3_zero_act", [x, w, s, t], {})]
    return calls


def check_kernels(calls):
    """Each call through its kernel and its plain version; returns
    {kernel: max abs error}. The pool must agree bit for bit (NaN where
    the plain version has NaN), the convs within CONV_TOL."""
    err = {name: 0.0 for name in KERNELS}
    for name, args, kwargs in calls:
        mod, attr, plain, _, _ = KERNELS[name]
        got = getattr(mod, attr)(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        same_nan = torch.equal(got.isnan(), want.isnan())
        e = (got - want).nan_to_num().abs().max().item()
        err[name] = max(err[name], e)
        if name == "maxpool3x3s2":
            ok = same_nan and torch.equal(got.nan_to_num(), want.nan_to_num())
        else:
            ok = torch.allclose(got, want, **CONV_TOL)
        require(ok, f"{name} differs at {shapes}: max abs {e}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name)

    tmp = tempfile.TemporaryDirectory()
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 weights_init="scratch", eval_batch_size=1, log_dir=tmp.name)
    # a weights folder, loaded by both entry points as a user's would be
    cfg = cfg.replace(load_weights_folder=ckpt.save_checkpoint(
        cfg, seeded_weights(cfg), "smoke"))
    frames = SmokeFrames(cfg, FRAMES)
    infer = Infer(cfg, device=dev)
    nets = infer.nets
    one = device_batch(collate([frames[0]]), dev)
    four = device_batch(collate([frames[i] for i in range(4)]), dev)

    # 4: every kernel on the inputs one batch-1 forward gives it
    calls = []
    with plain_kernels(record=calls):
        nets.forward_depth(one)
    edges = edge_calls(dev)
    err = check_kernels(calls + edges)
    for name, e in err.items():
        emit(check=name, calls_per_forward=sum(c[0] == name for c in calls),
             edge_cases=sum(c[0] == name for c in edges), max_abs_err=e,
             tol=0.0 if name == "maxpool3x3s2" else CONV_TOL)

    # 5: the main path, through the entry points
    launches = {}
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t = time.perf_counter()
        n = infer.run_split(frames, out)
        torch.cuda.synchronize()
        launches["infer"] = dict(LAUNCHES)
        secs = time.perf_counter() - t
        require(n == FRAMES, f"run_split wrote {n} of {FRAMES} frames")
        for i in range(FRAMES):
            folder, idx, side = frames.parse_line(i)
            d = np.load(os.path.join(out, folder, infer.out_folder(),
                                     f"{idx}_{side}.npy"))
            require(d.shape == (1, 1, HEIGHT, WIDTH) and
                    d.dtype == np.float32, f"frame {i}: {d.shape} {d.dtype}")
            require(bool(np.isfinite(d).all() and (d > 0).all() and
                         (d < 1).all()), f"frame {i}: disparity not in (0, 1)")
    emit(phase="infer_run_split", frames=n, seconds=secs,
         launches=launches["infer"])

    reset_launches()
    t = time.perf_counter()
    disps, _ = predict_disparities(
        cfg.replace(eval_batch_size=4, post_process=True), frames,
        device=dev)
    torch.cuda.synchronize()
    launches["predict"] = dict(LAUNCHES)
    emit(phase="predict_disparities", frames=len(disps),
         seconds=time.perf_counter() - t, launches=launches["predict"])
    require(len(disps) == FRAMES, f"{len(disps)} disparities")
    for d in disps:
        require(d.shape == (HEIGHT, WIDTH) and bool(np.isfinite(d).all())
                and bool(((d > 0) & (d < 1)).all()),
                "predicted disparity not finite in (0, 1)")
    for path, counts in launches.items():
        for name, c in counts.items():
            require(c > 0, f"{path}: kernel {name} was never launched")

    reset_launches()
    got = nets.forward_depth(four)[0]
    require(all(LAUNCHES.values()), f"kernel forward launched {LAUNCHES}")
    reset_launches()
    with plain_kernels():
        want = nets.forward_depth(four)[0]
    require(not any(LAUNCHES.values()), f"plain forward launched {LAUNCHES}")
    fwd_err = max((got[k] - want[k]).abs().max().item() for k in want)
    emit(check="forward_vs_all_plain", batch=4, max_abs_err=fwd_err,
         atol=FORWARD_ATOL)
    require(fwd_err <= FORWARD_ATOL, f"forward differs from all-plain by "
            f"{fwd_err}")

    # 6: times
    card = card_line()
    ms = {name: [0.0, 0.0] for name in KERNELS}
    for name, args, kwargs in calls:
        mod, attr, plain, _, _ = KERNELS[name]
        fn = getattr(mod, attr)
        k, p = paired_ms(lambda: fn(*args, **kwargs),
                         lambda: plain(*args, **kwargs))
        ms[name][0] += k
        ms[name][1] += p
    for name, (k, p) in ms.items():
        emit(timing=name, per="batch-1 forward, all its calls", ms=k,
             plain_ms=p, card=card)
    for label, b in (("batch1", one), ("batch4", four)):
        def run_plain():
            with plain_kernels():
                nets.forward_depth(b)
        k, p = paired_ms(lambda: nets.forward_depth(b), run_plain, iters=10)
        emit(timing="forward_depth", batch=label, ms=k, plain_ms=p,
             card=card)

    # 7: the result
    print(card)
    emit(kernels=[{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches["infer"][name], "max_abs_err": err[name],
        "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, (_, _, _, src, tpu) in KERNELS.items()])
    tmp.cleanup()
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
