"""Time the kernels of several source trees on one card, in turns.

    python3 scripts/ab_kernels.py [--sass OUT_DIR] OTHER_CSRC [OTHER_CSRC ...]

Builds `fusiondepth_torch/kernels/csrc` ("this") and each OTHER_CSRC (a
directory of `.cu` files with the same C entry points, at least
`maxpool3x3s2.cu`, `reproj.cu` and `knn.cu`: the parent commit's, unpacked
with `git archive`, or a variant of this tree's) into libraries of their
own, every `nvcc` started together, and prints each tree's registers and
SASS loop lengths of the kernels of LOOP_KERNELS (with --sass, their whole
SASS as well, one file per tree and source under OUT_DIR). Then, on inputs made
from a seed, it holds each tree's kernels against their plain versions
and times them with CUDA events, the trees in the order others, this,
this, others reversed: the pool backward's four calls and the
reprojection loss's forward (the warp and the identity call) and backward
calls of a batch-12 train step at 640x192, and the KNN on frame-like
clouds of N = 40960 (GDC's default capacities) and N = 77824 (capacities
that hold a whole frame). The pool must agree bit for bit, the
reprojection map within chip_smoke's REPROJ_ATOL and its cotangent within
REPROJ_BWD_TOL, the KNN index for index. Prints one JSON line per kernel
and call shape, with the card's name and power limit. Needs one CUDA card
and nvcc.
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

from fusiondepth_torch.kernels import build, knn, pool, reproj  # noqa: E402

REPROJ_ATOL = 1e-5
# the sources every tree must hold: the C entry points of the kernels timed
REQUIRED = ("maxpool3x3s2.cu", "reproj.cu", "knn.cu")
REPROJ_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# kernels whose registers and loops are printed: name fragments of their
# mangled names (the KNN at k = 10, the forward at C = 3, as GDC and the
# train step launch them)
LOOP_KERNELS = ("bwd_kernel", "reproj_fwd_kernelILi3E",
                "knn_partial_kernelILi10E", "knn_merge_kernelILi10E")


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


def calls(dev):
    """(kernel, wrapper, plain version, args) of the calls held and timed:
    the pool backward's four calls, the reprojection loss's forward (the
    8 warps and the identity maps) and backward calls of a batch-12 train
    step at 640x192 (the pool input ReLU-like, so that all-zero windows
    tie), and the KNN at N = 40960 and N = 77824."""
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
    for n_pl, cap_pl in ((67400, 32768), (67400, 69632)):
        pts = torch.from_numpy(frame_cloud(n_pl, cap_pl, 8192)).to(dev)
        out.append(("knn", knn.knn, knn.knn_plain, [pts, 10]))
    return out


def holds(name, got, want):
    """(ok, max abs error) of a kernel's result against the plain one; for
    the KNN, the number of indices that differ."""
    if name == "knn":
        return torch.equal(got, want), float((got != want).sum())
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
        print(json.dumps(dict(
            kernel=name, shapes=[list(a.shape) for a in args
                                 if torch.is_tensor(a)],
            ms={n: sum(v) / len(v) for n, v in ms.items()},
            checks=err, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
