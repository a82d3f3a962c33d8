"""Time the kernels of several source trees on one card, in turns.

    python3 scripts/ab_kernels.py OTHER_CSRC [OTHER_CSRC ...]

Builds `fusiondepth_torch/kernels/csrc` ("this") and each OTHER_CSRC (a
directory of `.cu` files with the same C entry points, at least
`maxpool3x3s2.cu` and `reproj.cu`: the parent commit's, unpacked with
`git archive`, or a variant of this tree's) into
libraries of their own, every `nvcc` started together. Then, on inputs of
a batch-12 train step made from a seed, it holds each tree's pool and
reprojection-loss backward against the plain version (the pool bit for
bit, the reprojection cotangent within chip_smoke.REPROJ_BWD_TOL) and
times each with CUDA events, the trees in the order others, this, this,
others reversed. Prints one JSON line per kernel and call shape, with the
card's name and power limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fusiondepth_torch.kernels import build, pool, reproj  # noqa: E402

REPROJ_BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def build_tree(csrc: Path, out: Path) -> ctypes.CDLL:
    """Compile every .cu of `csrc` into `out`/lib.so and bind it."""
    nvcc = build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    cu = sorted(csrc.glob("*.cu"))
    objs = [out / f"{src.stem}.o" for src in cu]
    outs = build._run_all([(str(src), [nvcc, *build.COMPILE_FLAGS, "-c",
                                       str(src), "-o", str(obj)])
                           for src, obj in zip(cu, objs)])
    # ptxas -v: the registers of each backward kernel
    regs, entry = {}, None
    for text in outs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            entry = m.group(1) if m else entry
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and "bwd_kernel" in entry:
                regs[entry[-40:]] = int(m.group(1))
    print(json.dumps(dict(tree=str(csrc), registers=regs,
                          loops=sass_loops(nvcc, objs))), flush=True)
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


def sass_loops(nvcc, objs):
    """{backward kernel: [instructions between each backward branch and
    its target]} from cuobjdump's SASS of the objects: the length of each
    loop's body as the card runs it."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    loops = {}
    for obj in objs:
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        for func in re.split(r"\n\s*Function : ", sass)[1:]:
            name = func.split("\n")[0]
            if "bwd_kernel" not in name:
                continue
            spans = []
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+[^;]*BRA[^;]*"
                                 r"0x([0-9a-f]+)", func):
                at, to = int(m.group(1), 16), int(m.group(2), 16)
                if to < at:
                    spans.append((at - to) // 16 + 1)
            loops[name[-40:]] = spans
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


def calls(dev):
    """The pool backward's four calls and the reprojection loss's backward
    call of a batch-12 train step at 640x192, inputs from a seed (the pool
    input ReLU-like, so that all-zero windows tie)."""
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
    gl = torch.randn((2, 4, 12, 192, 640), generator=g, device=dev)
    out.append(("reproj_bwd", reproj.reproj_bwd, reproj.reproj_bwd_plain,
                [warped, target, gl]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    here = Path(__file__).resolve().parents[1]
    trees = {"this": here / "fusiondepth_torch/kernels/csrc"}
    trees.update({a: Path(a).resolve() for a in sys.argv[1:]})
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build_tree(src, Path(tmp) / str(i))
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
            if name == "maxpool3x3s2_bwd":
                ok = torch.equal(got, want)
            else:
                ok = torch.allclose(got, want, **REPROJ_BWD_TOL)
            err[n] = dict(ok=bool(ok),
                          max_abs_err=(got - want).abs().max().item())
            ms[n].append(cuda_ms(lambda: wrapper(*args)))
        print(json.dumps(dict(
            kernel=name, shapes=[list(a.shape) for a in args],
            ms={n: sum(v) / len(v) for n, v in ms.items()},
            checks=err, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
