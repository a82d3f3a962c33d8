"""Smoke run of the PyTorch port (fusiondepth_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch; not JAX. In
order, it:

1. refuses to run without a card (exit code 1, no result printed);
2. turns TF32 off for the plain PyTorch comparisons;
3. builds the port's kernels from fusiondepth_torch/kernels/csrc;
4. inference: holds the forward kernels against their plain versions on
   the inputs the depth path gives them (ResNet-18 at 640x192, batch 1,
   weights and BatchNorm statistics made from a seed), then drives
   Infer.run_split over 8 synthetic frames at batch 1 and
   predict_disparities with the flip post-process at batch 4, both loading
   those weights as a checkpoint, with the launch counts set to 0 before
   each and read after; checks the cached files and disparities, that every
   forward kernel ran, and the forward against the all-plain one;
5. training (ResNet-18, 640x192, fp32): holds every kernel, forward and
   backward, against its plain version on the inputs a batch-2 train step
   records and on the edge cases of `edge_calls` (ties, NaN, odd and ragged
   sizes, border and far-out warp coordinates, a positive BN shift): the
   pools exactly, the warp at atol 1e-5, the convs and dgrad at atol and
   rtol 1e-4, wgrad to 1e-3 of the plain result's largest magnitude; checks
   a whole batch-2 step through the kernels against all-plain with the
   same weights and noise: the loss within 1e-5, and every gradient leaf
   against a float64 all-plain step, within 1e-3 or 3x the fp32 all-plain
   step's own error (STEP_NOISE_X); then drives
   Trainer.run_epoch over 36 synthetic frames (3 steps at batch 12) with
   the counts set to 0 before and read after, requires every kernel to
   have run and finite losses, saves a checkpoint and reloads it in Infer;
6. times each kernel against its plain version (and one PyTorch call that
   computes the same function, where there is one) over the calls of a
   batch-12 train step, the step through the kernels against all-plain,
   and the inference forward, with CUDA events after warm-up, each pair
   in the order plain, kernel, kernel, plain;
7. prints the card's name and power limit (nvidia-smi), then one JSON line
   {"kernels": [...]}, then, last, {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is not 0.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import collate
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.kernels import LAUNCHES, build, conv3x3, pool, \
    reset_launches
from fusiondepth_torch.kernels import warp as warp_kernel
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.norm import BatchNorm
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.eval_driver import predict_disparities
from fusiondepth_torch.training.infer_driver import Infer, device_batch
from fusiondepth_torch.training.train_state import loss_fn
from fusiondepth_torch.training.trainer import TRAIN_KEYS, Trainer

HEIGHT, WIDTH, FRAMES = 192, 640, 8
TRAIN_BATCH, TRAIN_FRAMES, CHECK_BATCH = 12, 36, 2
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
WARP_ATOL = 1e-5
WGRAD_REL = 1e-3
FORWARD_ATOL = 1e-4
# whole batch-2 step: the loss through the kernels within 1e-5 of
# all-plain; each gradient leaf's relative L2 distance to a float64
# all-plain step within 1e-3, or within 3x the fp32 all-plain step's own
# distance to it (the pose encoders' gradients are sums over every pixel
# of warp-coordinate gradients that nearly cancel: in fp32 the plain path
# itself is a few percent off float64 there, on the CPU as on the card)
STEP_LOSS_REL, STEP_GRAD_REL, STEP_NOISE_X = 1e-5, 1e-3, 3.0
# published H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 CUDA cores
PEAK_BYTES_S, PEAK_FP32_S = 3.35e12, 67e12

PALLAS = "fusiondepth_tpu/ops/"
SRC = "fusiondepth_torch/kernels/csrc/"
# kernel -> (wrapper module, wrapper, plain version, source, TPU kernel)
KERNELS = {
    "maxpool3x3s2": (pool, "maxpool3x3s2_fwd", pool.maxpool3x3s2_plain,
                     SRC + "maxpool3x3s2.cu", PALLAS + "pallas_pool.py:186"),
    "maxpool3x3s2_bwd": (pool, "maxpool3x3s2_bwd",
                         pool.maxpool3x3s2_bwd_plain,
                         SRC + "maxpool3x3s2.cu",
                         PALLAS + "pallas_pool.py:208"),
    "conv3x3_reflect": (conv3x3, "conv3x3_reflect_fwd",
                        conv3x3.conv3x3_reflect_plain, SRC + "conv3x3.cu",
                        PALLAS + "pallas_fold_conv.py:370"),
    "conv3x3_zero_act": (conv3x3, "conv3x3_zero_act_fwd",
                         conv3x3.conv3x3_zero_act_plain, SRC + "conv3x3.cu",
                         PALLAS + "pallas_fold_conv.py:370"),
    "conv3x3_dgrad": (conv3x3, "conv3x3_dgrad", conv3x3.conv3x3_dgrad_plain,
                      SRC + "conv3x3.cu",
                      PALLAS + "pallas_fold_conv.py:370 (_bwd :511, "
                      "_zbwd :615)"),
    "conv3x3_wgrad": (conv3x3, "conv3x3_wgrad", conv3x3.conv3x3_wgrad_plain,
                      SRC + "conv3x3.cu",
                      PALLAS + "pallas_fold_conv.py:466"),
    "warp": (warp_kernel, "warp_fwd", warp_kernel.warp_plain,
             SRC + "warp.cu", PALLAS + "pallas_warp.py:421"),
    "warp_bwd": (warp_kernel, "warp_bwd", warp_kernel.warp_bwd_plain,
                 SRC + "warp.cu", PALLAS + "pallas_warp.py:443"),
}
FORWARD_KERNELS = ("maxpool3x3s2", "conv3x3_reflect", "conv3x3_zero_act")


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
    """Inputs the main path does not give the kernels: tied, all-zero and
    NaN pool windows, odd pool sizes; convs with ragged tiles, channel
    counts that are no multiple of the kernels' channel tiles, a 2-channel
    second input (cat2end), 2x2 and 1x1 maps, and a positive BN shift,
    whose relu must not leak into the zero pad; warp coordinates exactly
    on the image border and displacements far beyond +-128 px, on a ragged
    H x W."""
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    tied = torch.randint(0, 3, (1, 64, HEIGHT // 2, WIDTH // 2),
                         generator=g, device=dev).float()
    relu = torch.relu(randn(2, 16, 24, 40))  # all-zero windows
    nan = randn(2, 3, 10, 10)
    nan[0, 1, 4, 4] = float("nan")
    calls = [("maxpool3x3s2", [x], {}) for x in
             (tied, nan, randn(2, 3, 7, 10), randn(1, 5, 1, 3))]
    for x in (tied, relu, nan):
        y = pool.maxpool3x3s2_plain(x)
        calls.append(("maxpool3x3s2_bwd", [x, y, randn(*y.shape)], {}))
    for B, C0, C1, Co, H, W, elu in ((2, 13, 2, 5, 11, 37, True),
                                     (1, 16, 0, 1, 2, 2, False),
                                     (2, 5, 3, 4, 2, 2, True),
                                     (2, 24, 9, 20, 90, 300, True)):
        x0 = randn(B, C0, H, W)
        x1 = randn(B, C1, H, W) if C1 else None
        w = randn(Co, C0 + C1, 3, 3, scale=0.2)
        gy = randn(B, Co, H, W)
        calls += [("conv3x3_reflect", [x0, w, randn(Co, scale=0.1), x1, elu],
                   {}),
                  ("conv3x3_dgrad", [gy, w, C0], {"reflect": True}),
                  ("conv3x3_wgrad", [gy, x0, x1], {"reflect": True})]
    for B, C, Co, H, W in ((2, 13, 7, 9, 33), (1, 4, 3, 1, 1),
                           (2, 20, 24, 2, 2),
                           (1, 64, 64, HEIGHT // 4, WIDTH // 4)):
        x, w = randn(B, C, H, W), randn(Co, C, 3, 3, scale=C ** -0.5 / 3)
        s = 0.5 + torch.rand(C, generator=g, device=dev)
        t = 0.2 + torch.rand(C, generator=g, device=dev)
        gy = randn(B, Co, H, W)
        calls += [("conv3x3_zero_act", [x, w], {}),
                  ("conv3x3_zero_act", [x, w, s, t], {}),
                  ("conv3x3_dgrad", [gy, w, C], {"reflect": False}),
                  ("conv3x3_wgrad", [gy, x, None],
                   {"reflect": False}),
                  ("conv3x3_wgrad", [gy, x, None],
                   {"reflect": False, "scale": s, "shift": t})]
    n, k, B, C, H, W = 2, 2, 2, 3, 37, 53
    jj = torch.arange(W, device=dev).float()
    ii = torch.arange(H, device=dev).float()[:, None]
    ix = (jj + 300 * randn(n, k, B, H, W)).clamp(0, W - 1)
    iy = (ii + 100 * randn(n, k, B, H, W)).clamp(0, H - 1)
    ix[0, 0, 0, :, :4] = 0.0
    ix[0, 0, 0, :, -4:] = W - 1.0
    iy[1, 1, 1, :3] = 0.0
    iy[1, 1, 1, -3:] = H - 1.0
    src = torch.rand((n, B, C, H, W), generator=g, device=dev)
    calls += [("warp", [ix, iy, src], {}),
              ("warp_bwd", [ix, iy, src, randn(n, k, B, C, H, W)], {})]
    return calls


def _tensors(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]


def check_kernels(calls):
    """Each call through its kernel and its plain version; returns
    {kernel: max abs error}. The pools must agree bit for bit (NaN where
    the plain version has NaN), the warp within WARP_ATOL, the convs and
    dgrad within CONV_TOL, wgrad within WGRAD_REL of the plain result's
    largest magnitude."""
    err = {}
    for name, args, kwargs in calls:
        mod, attr, plain, _, _ = KERNELS[name]
        got = _tensors(getattr(mod, attr)(*args, **kwargs))
        want = _tensors(plain(*args, **kwargs))
        torch.cuda.synchronize()
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        require(len(got) == len(want), f"{name}: outputs differ")
        for a, b in zip(got, want):
            e = (a - b).nan_to_num().abs().max().item()
            err[name] = max(err.get(name, 0.0), e)
            if name.startswith("maxpool"):
                ok = torch.equal(a.isnan(), b.isnan()) and torch.equal(
                    a.nan_to_num(), b.nan_to_num())
            elif name.startswith("warp"):
                ok = e <= WARP_ATOL
            elif name == "conv3x3_wgrad":
                ok = e <= WGRAD_REL * b.abs().max().item()
            else:
                ok = torch.allclose(a, b, **CONV_TOL)
            require(ok, f"{name} differs at {shapes}: max abs {e}")
    return err


def call_flops(name, args, kwargs) -> float:
    """Operations of one call, counted from its inputs: 2 per multiply-add
    of a conv (9 taps per input channel of each output), 16 per warped
    (pixel, channel) and 26 per backward one, 9 compares per pooled output
    and 36 per backward output."""
    if name in ("conv3x3_reflect", "conv3x3_zero_act"):
        x0, w = args[0], args[1]
        B, _, H, W = x0.shape
        return 2.0 * B * H * W * w.shape[0] * w.shape[1] * 9
    if name == "conv3x3_dgrad":
        g, w = args[0], args[1]
        B, _, H, W = g.shape
        return 2.0 * B * H * W * w.shape[0] * w.shape[1] * 9
    if name == "conv3x3_wgrad":
        g, x0, x1 = args[0], args[1], args[2]
        B, Co, H, W = g.shape
        ci = x0.shape[1] + (0 if x1 is None else x1.shape[1])
        return 2.0 * B * H * W * Co * ci * 9
    if name in ("warp", "warp_bwd"):
        src = args[2]
        return (16.0 if name == "warp" else 26.0) * args[0].numel() * \
            src.shape[2]
    if name == "maxpool3x3s2":
        return 9.0 * args[0].numel() / 4
    return 36.0 * args[1].numel()


def call_bytes(args, kwargs, out) -> float:
    """Each input read once and each output written once."""
    ins = [a for a in list(args) + list(kwargs.values()) if torch.is_tensor(a)]
    return float(sum(t.numel() * t.element_size() for t in ins + out))


def library_call(name, args, kwargs):
    """One PyTorch call that computes the same function as the kernel on
    these inputs, or None where there is none: F.grid_sample (border,
    align_corners=False) and its grid gradient for the warp, F.max_pool2d
    for the pool forward, and the cuDNN convolution and its input and
    weight gradients for the zero-pad convs without the act. None for the
    reflect convs (the pad and the concat are further calls), the act
    convs, and the tie-splitting pool backward."""
    if name in ("warp", "warp_bwd"):
        ix, iy, src = args[:3]
        n, k, B, H, W = ix.shape
        C = src.shape[2]
        inp = src[:, None].expand(n, k, B, C, H, W).reshape(-1, C, H, W)
        grid = torch.stack([(2 * ix + 1) / W - 1, (2 * iy + 1) / H - 1],
                           -1).reshape(-1, H, W, 2)
        if name == "warp":
            return lambda: F.grid_sample(inp, grid, padding_mode="border",
                                         align_corners=False)
        go = args[3].reshape(-1, C, H, W)
        return lambda: torch.ops.aten.grid_sampler_2d_backward(
            go, inp, grid, 0, 1, False, [False, True])
    if name == "maxpool3x3s2":
        return lambda: F.max_pool2d(args[0], 3, 2, 1)
    if name == "conv3x3_zero_act" and args[2] is None:
        return lambda: F.conv2d(args[0], args[1], padding=1)
    if name == "conv3x3_dgrad" and not kwargs["reflect"]:
        g, w, C0 = args
        shape = (g.shape[0], w.shape[1], g.shape[2], g.shape[3])
        return lambda: torch.nn.grad.conv2d_input(shape, w, g, padding=1)
    if name == "conv3x3_wgrad" and not kwargs["reflect"] and \
            kwargs.get("scale") is None:
        g, x0 = args[0], args[1]
        wshape = (g.shape[1], x0.shape[1], 3, 3)
        return lambda: torch.nn.grad.conv2d_weight(x0, wshape, g, padding=1)
    return None


def time_kernels(calls):
    """Per kernel, summed over its calls: kernel ms, plain ms, the library
    call's ms and the kernel's ms over the calls the library call covers,
    and the bound (bytes over the HBM rate or fp32 operations over the
    fp32 rate, the larger, call by call)."""
    t = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, library_of_ms=0.0,
                    library_calls=0, calls=0, bound_ms=0.0, bytes_ms=0.0,
                    ops_ms=0.0) for name in KERNELS}
    for name, args, kwargs in calls:
        mod, attr, plain, _, _ = KERNELS[name]
        fn = getattr(mod, attr)
        k, p = paired_ms(lambda: fn(*args, **kwargs),
                         lambda: plain(*args, **kwargs), iters=10, warmup=2)
        r = t[name]
        r["ms"] += k
        r["plain_ms"] += p
        r["calls"] += 1
        out = _tensors(plain(*args, **kwargs))
        b_ms = call_bytes(args, kwargs, out) / PEAK_BYTES_S * 1e3
        o_ms = call_flops(name, args, kwargs) / PEAK_FP32_S * 1e3
        r["bytes_ms"] += b_ms
        r["ops_ms"] += o_ms
        r["bound_ms"] += max(b_ms, o_ms)
        lib = library_call(name, args, kwargs)
        if lib is not None:
            lib_ms = (cuda_ms(lib, iters=10, warmup=2)
                      + cuda_ms(lib, iters=10, warmup=2)) / 2
            r["library_ms"] += lib_ms
            r["library_of_ms"] += k
            r["library_calls"] += 1
    for r in t.values():
        r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] \
            else "operations"
        if not r["library_calls"]:
            r["library_ms"] = r["library_of_ms"] = None
    return t


def step_noise(cfg: Config, batch: int, dev):
    """Automask noise for one step, 1e-5 * N(0, 1) per scale, from numpy:
    the same draws for the kernel and the all-plain step."""
    rng = np.random.default_rng(5)
    n = len(cfg.frame_ids) - 1
    return [torch.as_tensor(rng.standard_normal(
        (n, batch, cfg.height, cfg.width)) * 1e-5, dtype=torch.float32,
        device=dev) for _ in cfg.scales]


def step_grads(cfg, nets, batch, noise):
    """(loss, {param: grad}) of one training-mode step, no update."""
    nets.zero_grad(set_to_none=True)
    loss, _ = loss_fn(cfg, nets, batch, noise=noise)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in nets.named_parameters()}


def infer_phase(dev, tmp):
    """Step 4: the inference path, as in the first slice."""
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 weights_init="scratch", eval_batch_size=1, log_dir=tmp)
    # a weights folder, loaded by both entry points as a user's would be
    cfg = cfg.replace(load_weights_folder=ckpt.save_checkpoint(
        cfg, seeded_weights(cfg), "smoke"))
    frames = SmokeFrames(cfg, FRAMES)
    infer = Infer(cfg, device=dev)
    nets = infer.nets
    one = device_batch(collate([frames[0]]), dev)
    four = device_batch(collate([frames[i] for i in range(4)]), dev)

    calls = []
    with torch.no_grad():
        with plain_kernels(record=calls):
            nets.forward_depth(one)
    edges = [c for c in edge_calls(dev) if c[0] in FORWARD_KERNELS]
    err = check_kernels(calls + edges)
    for name, e in err.items():
        emit(check=name, path="infer",
             calls_per_forward=sum(c[0] == name for c in calls),
             edge_cases=sum(c[0] == name for c in edges), max_abs_err=e)

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
        for name in FORWARD_KERNELS:
            require(counts[name] > 0,
                    f"{path}: kernel {name} was never launched")

    with torch.no_grad():
        reset_launches()
        got = nets.forward_depth(four)[0]
        require(all(LAUNCHES[k] for k in FORWARD_KERNELS),
                f"kernel forward launched {LAUNCHES}")
        reset_launches()
        with plain_kernels():
            want = nets.forward_depth(four)[0]
        require(not any(LAUNCHES.values()),
                f"plain forward launched {LAUNCHES}")
        fwd_err = max((got[k] - want[k]).abs().max().item() for k in want)
        emit(check="forward_vs_all_plain", batch=4, max_abs_err=fwd_err,
             atol=FORWARD_ATOL)
        require(fwd_err <= FORWARD_ATOL, f"forward differs from all-plain "
                f"by {fwd_err}")

        card = card_line()
        for label, b in (("batch1", one), ("batch4", four)):
            def run_plain():
                with plain_kernels():
                    nets.forward_depth(b)
            k, p = paired_ms(lambda: nets.forward_depth(b), run_plain,
                             iters=10)
            emit(timing="forward_depth", batch=label, ms=k, plain_ms=p,
                 card=card)
    return err, launches


def train_phase(dev, tmp):
    """Step 5 and the step timings of step 6: the training path."""
    cfg = Config(num_layers=18, height=HEIGHT, width=WIDTH,
                 batch_size=TRAIN_BATCH, weights_init="scratch",
                 log_dir=tmp, num_workers=4, log_frequency=1,
                 model_name="smoke_train")
    data = SyntheticDataset(cfg, length=TRAIN_FRAMES, seed=2)
    nets = seeded_weights(cfg).to(dev)
    small = device_batch(collate([data[i] for i in range(CHECK_BATCH)]),
                         dev, TRAIN_KEYS)
    noise = step_noise(cfg, CHECK_BATCH, dev)

    # every kernel on the inputs a batch-2 train step gives it
    calls = []
    with plain_kernels(record=calls):
        loss_fn(cfg, nets, small, noise=noise)[0].backward()
    nets.zero_grad(set_to_none=True)
    edges = edge_calls(dev)
    err = check_kernels(calls + edges)
    for name, e in err.items():
        emit(check=name, path="train",
             calls_per_step=sum(c[0] == name for c in calls),
             edge_cases=sum(c[0] == name for c in edges), max_abs_err=e)
    del calls, edges

    # a whole batch-2 step through the kernels against all-plain, both
    # held against an all-plain float64 step of the same weights
    reset_launches()
    loss_k, grads_k = step_grads(cfg, nets, small, noise)
    require(all(LAUNCHES.values()), f"kernel step launched {LAUNCHES}")
    with plain_kernels():
        loss_p, grads_p = step_grads(cfg, nets, small, noise)
        cfg64 = cfg.replace(compute_dtype="float64")
        ref = copy.deepcopy(nets).double()
        ref.cfg = cfg64
        loss_r, grads_r = step_grads(
            cfg64, ref, {k: v.double() for k, v in small.items()},
            [n.double() for n in noise])
    del ref
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rows = []
    for n in grads_r:
        r = grads_r[n].norm().clamp_min(1e-30)
        rows.append((((grads_k[n].double() - grads_r[n]).norm() / r).item(),
                     ((grads_p[n].double() - grads_r[n]).norm() / r).item(),
                     ((grads_k[n] - grads_p[n]).norm()
                      / grads_p[n].norm().clamp_min(1e-30)).item(), n))
    bad = [row for row in rows if row[0] > max(STEP_GRAD_REL,
                                               STEP_NOISE_X * row[1])]
    worst_kp = max(rows, key=lambda row: row[2])
    worst_k = max(rows, key=lambda row: row[0])
    emit(check="train_step_vs_all_plain", batch=CHECK_BATCH, loss=loss_k,
         loss_rel_diff=loss_rel, loss_f64=loss_r,
         loss_rel_diff_f64=abs(loss_k - loss_r) / abs(loss_r),
         worst_grad_rel_l2=worst_kp[2], worst_leaf=worst_kp[3],
         leaves_over_1e3=sum(row[2] > STEP_GRAD_REL for row in rows),
         worst_kernel_vs_f64=worst_k[0], its_plain_vs_f64=worst_k[1],
         worst_kernel_leaf=worst_k[3], leaves=len(rows),
         tol=[STEP_LOSS_REL, STEP_GRAD_REL, STEP_NOISE_X])
    require(loss_rel <= STEP_LOSS_REL, f"step loss differs by {loss_rel}")
    require(not bad, f"gradient leaves off float64 beyond the plain "
            f"path's own error: {bad[:5]}")
    del nets, grads_k, grads_p, grads_r

    # the entry point: 3 steps at batch 12 through the kernels
    trainer = Trainer(cfg, train_dataset=data, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    losses = [float(x) for x in trainer.run_epoch()]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    secs = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    emit(phase="trainer_run_epoch", steps=len(losses), batch=TRAIN_BATCH,
         seconds=secs, losses=losses, launches=launches,
         peak_memory_gib=peak_gib)
    require(len(losses) == TRAIN_FRAMES // TRAIN_BATCH,
            f"{len(losses)} steps")
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    for name, c in launches.items():
        require(c > 0, f"train: kernel {name} was never launched")

    path = trainer.save("smoke")
    infer = Infer(cfg.replace(load_weights_folder=path), device=dev)
    probe = device_batch(collate([data[i] for i in range(4)]), dev)
    with torch.no_grad():
        want = trainer.nets.forward_depth(probe, train=False)[0][("disp", 0)]
        got = infer.infer(probe)
    reload_err = (got - want).abs().max().item()
    emit(check="checkpoint_reload_in_infer", max_abs_err=reload_err)
    require(reload_err <= 1e-6, f"reloaded bundle differs by {reload_err}")

    # timings at batch 12: each kernel over the calls of one step, and the
    # step itself through the kernels against all-plain
    big = trainer.put_batch(collate([data[i] for i in range(TRAIN_BATCH)]))
    calls = []
    with plain_kernels(record=calls):
        loss_fn(cfg, trainer.nets, big)[0].backward()
    trainer.nets.zero_grad(set_to_none=True)
    ktimes = time_kernels(calls)
    del calls

    def kernel_step():
        trainer.run_step(big, on_device=True)

    def plain_step():
        with plain_kernels():
            trainer.run_step(big, on_device=True)

    step_ms, plain_step_ms = paired_ms(kernel_step, plain_step, iters=3,
                                       warmup=1)
    emit(timing="train_step", batch=TRAIN_BATCH, ms=step_ms,
         plain_ms=plain_step_ms,
         samples_per_s=TRAIN_BATCH / step_ms * 1e3,
         plain_samples_per_s=TRAIN_BATCH / plain_step_ms * 1e3,
         kernels_ms=sum(r["ms"] for r in ktimes.values()),
         peak_memory_gib=peak_gib)
    return err, launches, ktimes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name)

    with tempfile.TemporaryDirectory() as tmp:
        infer_err, infer_launches = infer_phase(dev, tmp)
        train_err, train_launches, ktimes = train_phase(dev, tmp)
    card = card_line()
    for name, r in ktimes.items():
        emit(timing=name, per=f"batch-{TRAIN_BATCH} train step, all its "
             "calls", card=card, **r)

    print(card)
    kernels = []
    for name, (_, _, _, src, tpu) in KERNELS.items():
        r = ktimes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": train_launches[name],
            "max_abs_err": max(train_err.get(name, 0.0),
                               infer_err.get(name, 0.0)),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_of_ms": r["library_of_ms"],
            "calls_per_step": r["calls"],
            "launches_by_path": {p: c[name]
                                 for p, c in infer_launches.items()}})
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
