"""Build and load the hand-written CUDA kernels of `kernels/csrc`.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface under `kernels/build/`. The library is
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. `load()` does this on first use and
binds every entry point with `ctypes`; nothing is compiled when a module is
imported.

There is no fallback: a missing `nvcc` or a failed compile raises, and so
does a launch whose C entry point returns a CUDA error (see `check`).

Each source is compiled with `-Xptxas -v`; what ptxas reports (registers,
spills, static shared memory of every kernel) is kept beside the library
and read back by `ptxas_report`.

Processes that reach `build` together (the ranks of a data-parallel run)
take a file lock in the build directory: one compiles, the others wait
and load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")
NVCC_TIMEOUT_S = 900

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry point -> argument types. Pointers and the stream are c_void_p:
# ctypes would otherwise pass a Python int as a 32-bit int and cut it.
SIGNATURES = {
    # x, y, B, C, H, W, stream
    "fd_maxpool3x3s2_fwd": (_P, _P, _I, _I, _I, _I, _P),
    # x0, C0, x1, C1, w, bias, y, B, H, W, Co, elu, nt, stream
    "fd_conv3x3_reflect_fwd": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _P),
    # x, C, w, scale, shift, y, B, H, W, Co, nt, stream
    "fd_conv3x3_zero_act_fwd": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P),
    # g, Co, wt, dxp, dx0, C0, dx1, C1, B, H, W, reflect, nt, stream
    "fd_conv3x3_dgrad": (_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                         _P),
    # g, Co, x0, C0, x1, C1, scale, shift, part, dw, B, H, W, reflect, mw,
    # splits, stream
    "fd_conv3x3_wgrad": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P),
    # x, y, g, dx, B, C, H, W, stream
    "fd_maxpool3x3s2_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # ix, iy, src, out, N, K, B, C, H, W, stream
    "fd_warp_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # ix, iy, src, g, gix, giy, N, K, B, C, H, W, stream
    "fd_warp_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # warped, target, out, N*K, B, C, H, W, stream
    "fd_reproj_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # warped, target, g, dwarped, N*K, B, C, H, W, stream
    "fd_reproj_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # N, k
    "fd_knn_splits": (_I, _I),
    # pts, N, k, part_d, part_i, out, stream
    "fd_knn": (_P, _I, _I, _P, _P, _P, _P),
}
# the bfloat16 entry points: the same arguments, bf16 tensors (the conv's
# bias and scratch and the warp's coordinates and their gradients stay
# float32; csrc/*.cu)
SIGNATURES.update({name + "_bf16": SIGNATURES[name] for name in (
    "fd_maxpool3x3s2_fwd", "fd_maxpool3x3s2_bwd", "fd_conv3x3_reflect_fwd",
    "fd_conv3x3_zero_act_fwd", "fd_conv3x3_dgrad", "fd_conv3x3_wgrad",
    "fd_warp_fwd", "fd_warp_bwd", "fd_reproj_fwd", "fd_reproj_bwd")})


def find_nvcc() -> str:
    """`$NVCC`, then `$CUDA_HOME/bin/nvcc` (default `/usr/local/cuda`),
    then `nvcc` on `PATH`; raises if none is an executable file."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"),
                 os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, $CUDA_HOME/bin/nvcc and PATH): "
        "the fusiondepth_torch CUDA kernels are built from source at first "
        "use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir / f"libfusiondepth_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with every failure's output,
    else return {name: output}."""
    procs = [(name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
             for name, cmd in cmds]
    failures, outs = [], {}
    try:
        for name, p in procs:
            out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
            outs[name] = out
            if p.returncode != 0:
                failures.append(f"--- {name} (exit {p.returncode})\n{out}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return outs


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources into the shared library unless it exists."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():  # else another process built it meanwhile
            _compile(lib, build_dir)
    return lib


def _compile(lib: Path, build_dir: Path) -> None:
    nvcc = find_nvcc()
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        outs = _run_all([(src.name, [nvcc, *COMPILE_FLAGS, "-c", str(src),
                                     "-o", str(obj)])
                         for src, obj in zip(cu, objs)])
        _report_path(lib).write_text(json.dumps(outs))
        staged = Path(tmp) / lib.name
        _run_all([("link", [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                            *map(str, objs)])])
        os.replace(staged, lib)  # atomic: a concurrent builder sees all or none


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.json")


def ptxas_report(source: str, build_dir: Path = BUILD_DIR):
    """What ptxas said of each kernel of `source` (a file name under
    csrc/) when the current library was built: [{"kernel": mangled name,
    "registers": n, "spill_stores": bytes, "spill_loads": bytes,
    "static_smem": bytes, "stack": bytes}], in the order compiled."""
    out = json.loads(_report_path(library_path(build_dir)).read_text())
    rows = []
    for line in out.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append({"kernel": m.group(1), "registers": None,
                         "spill_stores": None, "spill_loads": None,
                         "static_smem": 0, "stack": None})
            continue
        if not rows:
            continue
        row = rows[-1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            row["stack"], row["spill_stores"], row["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            row["static_smem"] = int(m.group(1))
    return rows


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and bind every entry point of SIGNATURES."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fd_error_string.argtypes = (ctypes.c_int,)
    lib.fd_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error: a launch refused for
    its configuration never runs, and a later synchronize would not say so."""
    if err != 0:
        msg = load().fd_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
