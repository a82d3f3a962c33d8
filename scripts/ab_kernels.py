"""Time the kernels of several source trees on one card, in turns.

    python3 scripts/ab_kernels.py [--sass OUT_DIR] OTHER_CSRC [OTHER_CSRC ...]

Builds `fusiondepth_torch/kernels/csrc` ("this") and each OTHER_CSRC (a
directory of `.cu` files with the same C entry points, at least
`maxpool3x3s2.cu`, `reproj.cu`, `knn.cu` and `warp.cu`, with the
`dtype.cuh` they include where they are this tree's or later: the parent
commit's, unpacked with `git archive`, or a variant of this tree's) into
libraries of their own, every `nvcc` started together, and prints each
tree's registers and SASS loop lengths of the kernels of LOOP_KERNELS
(with --sass, their whole SASS as well, one file per tree and source
under OUT_DIR). Then, on inputs made from a seed, it holds each tree's
kernels against their plain versions and times them with CUDA events,
the trees in the order others, this, this, others reversed: the pool
backward's four calls and the reprojection loss's forward (the warp and
the identity call) and backward calls of a batch-12 train step at
640x192; the warp forward and backward of a batch-12 train step and of a
batch-4 refine step (coordinates near the identity with a few pixels of
flow, an assumed smooth flow: no trained model's warp coordinates have
been recorded; at b12 also displacements of hundreds of pixels, and the
calls a b12 train step records as chip_smoke.py times it, the reference
traffic); and the KNN on frame-like clouds of N = 40960
(GDC's default capacities) and N = 77824 (capacities that hold a whole
frame). The pool must agree bit for bit, the reprojection map within
chip_smoke's REPROJ_ATOL and its cotangent within REPROJ_BWD_TOL, the
warp and its coordinate cotangents within WARP_ATOL, the KNN index for
index. Prints one JSON line
per kernel and call shape (each tree's two runs in `ms_runs`, a warp
call's displacements in `flow_px`), with the card's name and power
limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fusiondepth_torch.kernels import (  # noqa: E402
    build, knn, pool, reproj, warp)

REPROJ_ATOL = 1e-5
WARP_ATOL = 1e-5
# the sources every tree must hold: the C entry points of the kernels timed
REQUIRED = ("maxpool3x3s2.cu", "reproj.cu", "knn.cu", "warp.cu")
REPROJ_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# kernels whose registers and loops are printed: name fragments of their
# mangled names (the KNN at k = 10, the forward at C = 3, as GDC and the
# train step launch them; "bwd_kernel" takes the warp backward too)
LOOP_KERNELS = ("bwd_kernel", "reproj_fwd_kernelILi3E",
                "knn_partial_kernelILi10E", "knn_merge_kernelILi10E",
                "warp_fwd_kernel")


def build_tree(csrc: Path, out: Path, sass_dir=None) -> ctypes.CDLL:
    """Compile every .cu of `csrc` into `out`/lib.so and bind it."""
    nvcc = build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    cu = sorted(csrc.glob("*.cu"))
    objs = [out / f"{src.stem}.o" for src in cu]
    outs = build._run_all([(str(src), [nvcc, *build.COMPILE_FLAGS, "-c",
                                       str(src), "-o", str(obj)])
                           for src, obj in zip(cu, objs)])
    # ptxas -v: the registers and spilled bytes of each kernel
    regs, entry = {}, None
    for text in outs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            entry = m.group(1) if m else entry
            if not (entry and any(k in entry for k in LOOP_KERNELS)):
                continue
            r = regs.setdefault(entry[-40:], {})
            m = re.search(r"Used (\d+) registers", line)
            if m:
                r["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                r["spill_stores"] = int(m.group(1))
    print(json.dumps(dict(tree=str(csrc), registers=regs,
                          loops=sass_loops(nvcc, objs, csrc, sass_dir))),
          flush=True)
    lib = out / "lib.so"
    build._run_all([("link", [nvcc, *build.ARCH_FLAGS, "-shared", "-o",
                              str(lib), *map(str, objs)])])
    so = ctypes.CDLL(str(lib))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(so, name):  # a tree may hold only the sources it varies
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    so.fd_error_string.argtypes = (ctypes.c_int,)
    so.fd_error_string.restype = ctypes.c_char_p
    return so


def sass_loops(nvcc, objs, csrc, sass_dir=None):
    """{kernel of LOOP_KERNELS: [instructions between each backward branch
    and its target]} from cuobjdump's SASS of the objects: the length of
    each loop's body as the card runs it."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    loops = {}
    for obj in objs:
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        kept = []
        for func in re.split(r"\n\s*Function : ", sass)[1:]:
            name = func.split("\n")[0]
            if not any(k in name for k in LOOP_KERNELS):
                continue
            kept.append(func)
            spans = []
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+[^;]*BRA[^;]*"
                                 r"0x([0-9a-f]+)", func):
                at, to = int(m.group(1), 16), int(m.group(2), 16)
                if to < at:
                    spans.append((at - to) // 16 + 1)
            loops[name[-40:]] = spans
        if sass_dir and kept:
            tag = "_".join(csrc.parts[-2:])
            Path(sass_dir, f"{tag}_{obj.stem}.sass").write_text(
                "\n\nFunction : ".join(kept))
    return loops


def cuda_ms(fn, iters=20, warmup=3) -> float:
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


def frame_cloud(n_pl, cap_pl, cap_l, n_l=2000, seed=0):
    """A GDC-like cloud of cap_pl + cap_l points: the first min(n_pl,
    cap_pl) pseudo-LiDAR points of a smooth depth field at 375x1242
    (KITTI's intrinsics), back-projected in raster order as gdc_correct
    takes them; n_l LiDAR points at random pixels of the same rows, in
    raster order, a few cm off; every unused slot at the 1e8 sentinel,
    spread along x by index."""
    rng = np.random.default_rng(seed)
    f, cu, cv, width = 721.5, 609.6, 172.9, 1242
    rows = -(-n_pl // width)
    v, u = np.mgrid[150:150 + rows, 0:width].astype(np.float64)
    d = (12 + 6 * np.sin(u / 90) + 3 * np.cos(v / 7)
         + 0.05 * rng.standard_normal(u.shape))

    def back(u, v, d):
        return np.stack([(u - cu) * d / f, (v - cv) * d / f, d], -1)

    pl = back(u, v, d).reshape(-1, 3)[:min(n_pl, cap_pl)]
    pick = np.sort(rng.choice(u.size, n_l, replace=False))
    lidar = back(u.ravel()[pick], v.ravel()[pick], d.ravel()[pick]) + \
        0.03 * rng.standard_normal((n_l, 3))
    pts = np.full((cap_pl + cap_l, 3), 1e8)
    pts[:len(pl)] = pl
    pts[cap_pl:cap_pl + n_l] = lidar
    pad = np.ones(len(pts), bool)
    pad[:len(pl)] = False
    pad[cap_pl:cap_pl + n_l] = False
    pts[pad, 0] += np.arange(len(pts))[pad]
    return pts.astype(np.float32)


def warp_coords(n, k, B, H, W, far, g):
    """Pixel coordinates ix, iy (n, k, B, H, W) of an assumed smooth flow
    (not recorded from a model): each (n, k, b) a zoom of up to 2% about
    the image centre and a shift of up to 4 px, plus 0.3 px of noise; with
    `far`, normal displacements of 300 px in x and 100 px in y instead.
    Clamped."""
    dev = g.device

    def axis(size, shape, spread):
        def uniform():
            return 2 * torch.rand((n, k, B, 1, 1), generator=g,
                                  device=dev) - 1

        c = torch.arange(size, device=dev, dtype=torch.float32).view(shape)
        noise = torch.randn((n, k, B, H, W), generator=g, device=dev)
        if far:
            return (c + spread * noise).clamp(0, size - 1)
        return ((c - size / 2) * (1 + 0.02 * uniform()) + size / 2
                + 4 * uniform() + 0.3 * noise).clamp(0, size - 1)

    return axis(W, (W,), 300.0), axis(H, (H, 1), 100.0)


def step_warp_calls(dev):
    """(kernel, args) of the warp forward and backward of a batch-12 train
    step at 640x192 as chip_smoke.py times them: the Trainer's own seeded
    init after one epoch of 3 steps over chip_smoke's synthetic frames."""
    import chip_smoke
    from fusiondepth_torch.config import Config
    from fusiondepth_torch.data.loader import collate
    from fusiondepth_torch.data.synthetic import SyntheticDataset
    from fusiondepth_torch.training.train_state import loss_fn
    from fusiondepth_torch.training.trainer import Trainer

    batch = chip_smoke.TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(num_layers=18, height=192, width=640, batch_size=batch,
                     weights_init="scratch", log_dir=tmp, num_workers=4,
                     log_frequency=1, model_name="ab_train")
        data = SyntheticDataset(cfg, length=chip_smoke.TRAIN_FRAMES, seed=2)
        trainer = Trainer(cfg, train_dataset=data, device=dev)
        trainer.run_epoch()
        frames = trainer.put_batch(collate([data[i] for i in range(batch)]))
        recorded = []
        with chip_smoke.plain_kernels(record=recorded):
            loss_fn(cfg, trainer.nets, frames)[0].backward()
    return [(name, args) for name, args, _ in recorded
            if name.startswith("warp")]


def flow_px(ix, iy):
    """Quantiles (50, 90, 99%) of each pixel's displacement |ix - x| and
    |iy - y| in pixels: how far a call's taps lie from the output."""
    H, W = ix.shape[-2:]
    q = torch.tensor([0.5, 0.9, 0.99], device=ix.device)
    out = {}
    for name, d in (("x", ix - torch.arange(W, device=ix.device)),
                    ("y", iy - torch.arange(H, device=ix.device)[:, None])):
        sample = d.abs().flatten()[::97].float()  # quantile takes < 16M
        out[name] = [round(v, 3) for v in torch.quantile(sample, q).tolist()]
    return out


def calls(dev):
    """(kernel, wrapper, plain version, args) of the calls held and timed:
    the pool backward's four calls, the reprojection loss's forward (the
    8 warps and the identity maps) and backward calls of a batch-12 train
    step at 640x192 (the pool input ReLU-like, so that all-zero windows
    tie), the warp forward and backward of a b12 train step and a b4
    refine step (`warp_coords`; at b12 also far displacements), and the
    KNN at N = 40960 and N = 77824."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for B in (12, 12, 24, 24):
        x = torch.relu(torch.randn((B, 64, 96, 320), generator=g,
                                   device=dev) - 0.3)
        y = pool.maxpool3x3s2_plain(x)
        out.append(("maxpool3x3s2_bwd", pool.maxpool3x3s2_bwd,
                    pool.maxpool3x3s2_bwd_plain,
                    [x, y, torch.randn(y.shape, generator=g, device=dev)]))
    warped = torch.rand((2, 4, 12, 3, 192, 640), generator=g, device=dev)
    target = torch.rand((12, 3, 192, 640), generator=g, device=dev)
    warped[1, 3, 11] = target[11]
    identity = torch.rand((2, 1, 12, 3, 192, 640), generator=g, device=dev)
    identity[0, 0, 5] = target[5]
    out += [("reproj", reproj.reproj_fwd, reproj.reproj_plain, [w, target])
            for w in (warped, identity)]
    gl = torch.randn((2, 4, 12, 192, 640), generator=g, device=dev)
    out.append(("reproj_bwd", reproj.reproj_bwd, reproj.reproj_bwd_plain,
                [warped, target, gl]))
    warps = []
    for B, far in ((12, False), (4, False), (12, True)):
        ix, iy = warp_coords(2, 4, B, 192, 640, far, g)
        src = torch.rand((2, B, 3, 192, 640), generator=g, device=dev)
        gw = torch.randn((2, 4, B, 3, 192, 640), generator=g, device=dev)
        warps += [("warp", [ix, iy, src]), ("warp_bwd", [ix, iy, src, gw])]
    kernels = {"warp": (warp.warp_fwd, warp.warp_plain),
               "warp_bwd": (warp.warp_bwd, warp.warp_bwd_plain)}
    out += [(name, *kernels[name], args)
            for name, args in warps + step_warp_calls(dev)]
    for n_pl, cap_pl in ((67400, 32768), (67400, 69632)):
        pts = torch.from_numpy(frame_cloud(n_pl, cap_pl, 8192)).to(dev)
        out.append(("knn", knn.knn, knn.knn_plain, [pts, 10]))
    return out


def holds(name, got, want):
    """(ok, max abs error) of a kernel's result against the plain one; for
    the KNN, the number of indices that differ."""
    if name == "knn":
        return torch.equal(got, want), float((got != want).sum())
    if name.startswith("warp"):
        pairs = zip(got, want) if name == "warp_bwd" else [(got, want)]
        e = max((a - b).abs().max().item() for a, b in pairs)
        return e <= WARP_ATOL, e
    e = (got - want).abs().max().item()
    if name == "maxpool3x3s2_bwd":
        return torch.equal(got, want), e
    if name == "reproj":
        return e <= REPROJ_ATOL, e
    return torch.allclose(got, want, **REPROJ_BWD_TOL), e


def main() -> int:
    here = Path(__file__).resolve().parents[1]
    args = sys.argv[1:]
    sass_dir = None
    if args[:1] == ["--sass"]:
        sass_dir = Path(args[1])
        args = args[2:]
    trees = {"this": here / "fusiondepth_torch/kernels/csrc"}
    trees.update({a: Path(a).resolve() for a in args})
    missing = [str(src / f) for src in trees.values() for f in REQUIRED
               if not (src / f).is_file()]
    if missing:
        print(f"ab_kernels: every tree needs {REQUIRED}; missing {missing}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if sass_dir:
        sass_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build_tree(src, Path(tmp) / str(i), sass_dir)
                for i, (name, src) in enumerate(trees.items())}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    others = [n for n in libs if n != "this"]
    order = others + ["this", "this"] + others[::-1]
    for name, wrapper, plain, args in calls(dev):
        want = plain(*args)
        ms = {n: [] for n in libs}
        err = {}
        for n in order:
            build.load = lambda lib=libs[n]: lib
            got = wrapper(*args)
            torch.cuda.synchronize()
            ok, e = holds(name, got, want)
            err[n] = dict(ok=bool(ok), **{
                "indices_differ" if name == "knn" else "max_abs_err": e})
            ms[n].append(cuda_ms(lambda: wrapper(*args)))
        extra = dict(flow_px=flow_px(*args[:2])) if name.startswith("warp") \
            else {}
        print(json.dumps(dict(
            kernel=name, shapes=[list(a.shape) for a in args
                                 if torch.is_tensor(a)],
            ms={n: sum(v) / len(v) for n, v in ms.items()},
            ms_runs=ms, checks=err, card=card, **extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
