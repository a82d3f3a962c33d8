"""Time the kernels of several source trees on one card, in turns.

    python3 scripts/ab_kernels.py [--sass OUT_DIR] [--kernels K1,K2,...]
                                  OTHER_CSRC [OTHER_CSRC ...]

Builds `fusiondepth_torch/kernels/csrc` ("this") and each OTHER_CSRC (a
directory of `.cu` files with the same C entry points, at least
`maxpool3x3s2.cu`, `reproj.cu`, `knn.cu` and `warp.cu`, with the
`dtype.cuh` they include where they are this tree's or later: the parent
commit's, unpacked with `git archive`, or a variant of this tree's) into
libraries of their own, every `nvcc` started together, and prints each
tree's registers and SASS loop lengths of the kernels of LOOP_KERNELS
(with --sass, their whole SASS as well, one file per tree and source
under OUT_DIR), and whether each float32 conv kernel's SASS is the same
as this tree's (`sass_equal`, names and addresses aside). Then, on inputs
made from a seed, it holds each tree's kernels against their plain
versions and times them with CUDA events, the trees in the order others,
this, this, others reversed: the conv calls of a batch-12 train step at
640x192 in float32 and in bfloat16 (reflect, zero-pad with and without
the act, dgrad, wgrad: every call the step makes, recorded from a step of
chip_smoke.py's seeded weights; one line per kernel and dtype, its calls
summed, with cuDNN's time on the calls a cuDNN call covers); the pool
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
index, the convs at chip_smoke's bounds (`chip_smoke.output_holds`).
Prints one JSON line per kernel and call shape (each tree's two runs in
`ms_runs`, a warp call's displacements in `flow_px`), with the card's name
and power limit. --kernels keeps the calls of those kernels only (names
as in kernels.F32_KERNELS). The other trees run with this tree's tile
choices (kernels/conv3x3.py::conv_tiles). Needs one CUDA card and nvcc.
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
    build, conv3x3, knn, pool, reproj, warp)

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
                "warp_fwd_kernel", "conv3x3_fwd_kernel", "conv3x3_wgrad_kernel",
                "conv3x3_fwd_bf16_kernel", "conv3x3_wgrad_bf16_kernel")
# the float32 conv instantiations whose SASS every tree is held to
F32_CONV = re.compile(r"conv3x3_(?:fwd|wgrad)_kernelIf\w*")
CONV_NAMES = ("conv3x3_reflect", "conv3x3_zero_act", "conv3x3_dgrad",
              "conv3x3_wgrad")
# the image size of the train step whose conv calls are timed
STEP_HW = (192, 640)


def kernel_key(entry: str) -> str:
    """A mangled kernel name from its kernel's name on (the namespace's
    tag dropped): unique within a tree, equal across trees."""
    at = min((entry.find(k) for k in LOOP_KERNELS if k in entry),
             default=-1)
    return entry[at:] if at >= 0 else entry[-40:]


def build_tree(csrc: Path, out: Path, sass_dir=None, tag="this"):
    """Compile every .cu of `csrc` into `out`/lib.so and bind it; returns
    (library, {float32 conv instantiation: SASS body})."""
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
            r = regs.setdefault(kernel_key(entry), {})
            m = re.search(r"Used (\d+) registers", line)
            if m:
                r["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                r["spill_stores"] = int(m.group(1))
    bodies = {}
    print(json.dumps(dict(tree=str(csrc), registers=regs,
                          loops=sass_loops(nvcc, objs, tag, sass_dir,
                                           bodies))),
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
    return so, bodies


def sass_body(func: str) -> str:
    """A function's SASS without its name line, addresses and encodings,
    and with anonymous-namespace tags blanked: what two builds of the same
    code share."""
    lines = []
    for line in func.split("\n")[1:]:
        line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line)
        line = re.sub(r"_GLOBAL__N__\w+?_", "_GLOBAL__N_", line).strip()
        if line:
            lines.append(line)
    return "\n".join(lines)


def sass_loops(nvcc, objs, tag, sass_dir=None, bodies=None):
    """{kernel of LOOP_KERNELS: [instructions between each backward branch
    and its target]} from cuobjdump's SASS of the objects: the length of
    each loop's body as the card runs it. With `bodies` (a dict), also
    {float32 conv instantiation: sass_body} into it."""
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
            conv = F32_CONV.search(name)
            if bodies is not None and conv:
                bodies[conv.group(0)] = sass_body(func)
            spans = []
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+[^;]*BRA[^;]*"
                                 r"0x([0-9a-f]+)", func):
                at, to = int(m.group(1), 16), int(m.group(2), 16)
                if to < at:
                    spans.append((at - to) // 16 + 1)
            loops[kernel_key(name)] = spans
        if sass_dir and kept:
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
    from fusiondepth_torch.kernels import all_plain
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
        with all_plain(record=recorded):
            loss_fn(cfg, trainer.nets, frames)[0].backward()
    return [(name, args) for name, args, _ in recorded
            if name.startswith("warp")]


def step_conv_calls(dev, dtype):
    """(kernel, args, kwargs) of every conv call of a batch-12 train step at
    640x192 in `dtype` ("float32" or "bfloat16"), recorded through the
    plain versions: chip_smoke.py's seeded weights and synthetic frames.
    A bf16 call's kernel name ends in "_bf16"."""
    import chip_smoke
    from fusiondepth_torch.config import Config
    from fusiondepth_torch.data.loader import collate
    from fusiondepth_torch.data.synthetic import SyntheticDataset
    from fusiondepth_torch.kernels import all_plain
    from fusiondepth_torch.training.infer_driver import device_batch
    from fusiondepth_torch.training.train_state import loss_fn
    from fusiondepth_torch.training.trainer import TRAIN_KEYS

    batch = chip_smoke.TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(num_layers=18, height=STEP_HW[0], width=STEP_HW[1],
                     batch_size=batch, weights_init="scratch", log_dir=tmp,
                     compute_dtype=dtype)
        data = SyntheticDataset(cfg, length=batch, seed=2)
        nets = chip_smoke.seeded_weights(cfg).to(dev)
        frames = device_batch(collate([data[i] for i in range(batch)]), dev,
                              TRAIN_KEYS)
        recorded = []
        with all_plain(record=recorded):
            loss_fn(cfg, nets, frames)[0].backward()
    return [c for c in recorded
            if chip_smoke.base_name(c[0]) in CONV_NAMES]


def graph_ms(fn, iters=10):
    """Milliseconds per call of fn replayed from a CUDA graph: the device's
    time without the host's launch overhead (None if fn cannot be
    captured)."""
    try:
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_ms(graph.replay, iters=iters, warmup=2)
    except RuntimeError:
        return None


def time_step_convs(dev, libs, order, keep, card):
    """The conv calls of a b12 step in float32 and bf16 (step_conv_calls)
    through each tree, in turns: per kernel and dtype one line, summed over
    the step's calls, and one `conv_call` line per call (its shapes, each
    tree's ms and graph-replayed device ms, cuDNN's where it covers the
    call)."""
    import chip_smoke

    for dtype in ("float32", "bfloat16"):
        calls = [c for c in step_conv_calls(dev, dtype)
                 if chip_smoke.base_name(c[0]) in keep]
        rows = {}
        for name, args, kwargs in calls:
            mod, attr, plain, _, _ = chip_smoke.KERNELS[name]
            fn = getattr(mod, attr)
            want = chip_smoke._tensors(plain(*args, **kwargs))
            r = rows.setdefault(name, dict(
                calls=0, ms={n: [0.0, 0.0] for n in libs}, plain_ms=0.0,
                bound_ms=0.0, library_ms=0.0, library_calls=0,
                library_of_ms={n: 0.0 for n in libs},
                checks={n: dict(ok=True, max_abs_err=0.0) for n in libs}))
            r["calls"] += 1
            lib_call = chip_smoke.library_call(name, args, kwargs)
            runs = {n: 0 for n in libs}
            one = {n: 0.0 for n in libs}  # this call's ms, mean of 2 runs
            for n in order:
                build.load = lambda lib=libs[n]: lib
                got = chip_smoke._tensors(fn(*args, **kwargs))
                torch.cuda.synchronize()
                c = r["checks"][n]
                for a, b in zip(got, want):
                    c["max_abs_err"] = max(c["max_abs_err"], (
                        a.float() - b.float()).abs().max().item())
                    c["ok"] = c["ok"] and bool(
                        chip_smoke.output_holds(name, a, b))
                k = cuda_ms(lambda: fn(*args, **kwargs), iters=10, warmup=2)
                r["ms"][n][runs[n]] += k
                runs[n] += 1
                one[n] += k / 2
                if lib_call is not None:
                    r["library_of_ms"][n] += k / 2
            device = {}
            for n in order[:len(libs)]:
                build.load = lambda lib=libs[n]: lib
                device[n] = graph_ms(lambda: fn(*args, **kwargs))
            r["plain_ms"] += cuda_ms(lambda: plain(*args, **kwargs), iters=5,
                                     warmup=1)
            r["bound_ms"] += max(
                chip_smoke.call_bytes(args, kwargs, want)
                / chip_smoke.PEAK_BYTES_S * 1e3,
                chip_smoke.ops_ms(name, args, kwargs))
            lib_ms = lib_dev = None
            if lib_call is not None:
                lib_ms = cuda_ms(lib_call, iters=10, warmup=2)
                lib_dev = graph_ms(lib_call)
                r["library_ms"] += lib_ms
                r["library_calls"] += 1
            print(json.dumps(dict(
                conv_call=name, shapes=[list(a.shape) for a in args
                                        if torch.is_tensor(a)],
                ms=one, device_ms=device, library_ms=lib_ms,
                library_device_ms=lib_dev)), flush=True)
        del calls
        for name, r in rows.items():
            print(json.dumps(dict(
                kernel=name, calls=r["calls"], per="all calls of one b12 "
                "train step at 640x192",
                ms={n: sum(v) / 2 for n, v in r["ms"].items()},
                ms_runs=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], library_ms=r["library_ms"] or None,
                library_calls=r["library_calls"],
                library_of_ms=r["library_of_ms"] if r["library_calls"]
                else None, checks=r["checks"], card=card)), flush=True)


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


def calls(dev, keep):
    """(kernel, wrapper, plain version, args) of the calls held and timed,
    of the kernels in `keep`: the pool backward's four calls, the
    reprojection loss's forward (the 8 warps and the identity maps) and
    backward calls of a batch-12 train step at 640x192 (the pool input
    ReLU-like, so that all-zero windows tie), the warp forward and backward
    of a b12 train step and a b4 refine step (`warp_coords`; at b12 also
    far displacements), and the KNN at N = 40960 and N = 77824."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for B in (12, 12, 24, 24) if "maxpool3x3s2_bwd" in keep else ():
        x = torch.relu(torch.randn((B, 64, 96, 320), generator=g,
                                   device=dev) - 0.3)
        y = pool.maxpool3x3s2_plain(x)
        out.append(("maxpool3x3s2_bwd", pool.maxpool3x3s2_bwd,
                    pool.maxpool3x3s2_bwd_plain,
                    [x, y, torch.randn(y.shape, generator=g, device=dev)]))
    if not keep & {"reproj", "reproj_bwd", "warp", "warp_bwd", "knn"}:
        return out
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
    if keep & {"warp", "warp_bwd"}:
        out += [(name, *kernels[name], args)
                for name, args in warps + step_warp_calls(dev)]
    for n_pl, cap_pl in ((67400, 32768), (67400, 69632)):
        pts = torch.from_numpy(frame_cloud(n_pl, cap_pl, 8192)).to(dev)
        out.append(("knn", knn.knn, knn.knn_plain, [pts, 10]))
    return [c for c in out if c[0] in keep]


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
    keep = None
    while args[:1] in (["--sass"], ["--kernels"]):
        if args[0] == "--sass":
            sass_dir = Path(args[1])
        else:
            keep = set(args[1].split(","))
        args = args[2:]
    from fusiondepth_torch.kernels import F32_KERNELS
    keep = set(F32_KERNELS) if keep is None else keep
    if not keep <= set(F32_KERNELS):
        print(f"ab_kernels: --kernels takes names of {F32_KERNELS}",
              file=sys.stderr)
        return 2
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
        built = {name: build_tree(src, Path(tmp) / str(i), sass_dir,
                                  "this" if name == "this" else f"tree{i}")
                 for i, (name, src) in enumerate(trees.items())}
    libs = {name: lib for name, (lib, _) in built.items()}
    bodies = {name: b for name, (_, b) in built.items()}
    print(json.dumps(dict(sass_equal={
        n: {k: bodies[n].get(k) == v for k, v in bodies["this"].items()}
        for n in bodies if n != "this"})), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    others = [n for n in libs if n != "this"]
    order = others + ["this", "this"] + others[::-1]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if keep & set(CONV_NAMES):
        time_step_convs(dev, libs, order, keep, card)
    for name, wrapper, plain, args in calls(dev, keep):
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
