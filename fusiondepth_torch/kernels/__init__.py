"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
launch counts.

Each wrapper takes its plain version for a tensor on the CPU (the tests run
there) and launches its kernel for a CUDA tensor, or raises; it never falls
back from the kernel to the plain version. A wrapper adds one to its entry
in `LAUNCHES` each time it launches its kernel, so a run can show that it
went through the kernels (see `chip_smoke.py`).

A kernel that needs a gradient is a `torch.autograd.Function` whose forward
and backward call such wrappers, so the backward pass launches kernels
too, each counted under its own name (`maxpool3x3s2_bwd`, `warp_bwd`,
`conv3x3_dgrad`, `conv3x3_wgrad`, `reproj_bwd`).

Every kernel but the KNN has a float32 and a bfloat16 entry point
(compute_dtype="bfloat16"). A wrapper picks the entry by the dtype of its
data tensor (`DATA_ARG`), checks that every tensor has the dtype that
entry takes (`check_cuda`) and raises on any other: no wrapper casts. A
bfloat16 launch counts under the kernel's name with "_bf16" appended
(`launch_key`); its plain version computes in float32 from the bf16
inputs and rounds once where the kernel stores bf16.

`all_plain` routes every wrapper to its plain version for a while (the
all-plain steps that `chip_smoke.py` and `bench.py` compare and count
against).
"""

from __future__ import annotations

import contextlib

import torch

F32_KERNELS = ("maxpool3x3s2", "maxpool3x3s2_bwd", "conv3x3_reflect",
               "conv3x3_zero_act", "conv3x3_dgrad", "conv3x3_wgrad", "warp",
               "warp_bwd", "reproj", "reproj_bwd", "knn")
# the kernels with a bfloat16 entry point, and its launch-count name
BF16_KERNELS = {k: k + "_bf16" for k in F32_KERNELS if k != "knn"}
LAUNCHES = {k: 0 for k in F32_KERNELS + tuple(BF16_KERNELS.values())}
# the argument whose dtype selects a wrapper's entry point (default 0):
# the warps' coordinates are float32 under either
DATA_ARG = {"warp": 2, "warp_bwd": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def on_card(x: torch.Tensor):
    """Make x's card the current one for a launch and yield the handle of
    its current stream; the caller's current card is restored after."""
    with torch.cuda.device(x.device):
        yield torch.cuda.current_stream().cuda_stream


def launch_key(name: str, dtype: torch.dtype) -> str:
    """The LAUNCHES entry of kernel `name`'s entry point for `dtype`."""
    return BF16_KERNELS[name] if dtype == torch.bfloat16 else name


def entry_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The dtype of the entry point that kernel `name` takes for its data
    tensor t: t's own, float32 or bfloat16; raises for any other."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: {t.dtype} tensors; the kernel has float32 "
                        "and bfloat16 entry points only")
    return t.dtype


def entry_point(fn: str, dtype: torch.dtype):
    """The bound C entry point `fn`, or its bfloat16 twin `fn`_bf16."""
    from fusiondepth_torch.kernels import build

    return getattr(build.load(), fn + ("_bf16" if dtype == torch.bfloat16
                                       else ""))


def check_cuda(name: str, dtype: torch.dtype, **tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor on one
    device, of `dtype`, or of the dtype paired with it as (tensor, dtype)
    (None entries are skipped). Nothing is cast."""
    devices = set()
    for arg, t in tensors.items():
        want = dtype
        if isinstance(t, tuple):
            t, want = t
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}; this entry point "
                            f"takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in the dtype a plain version computes in: float32 for bfloat16,
    its own otherwise (float32, or float64 in the parity tests)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def wrappers():
    """{kernel: (wrapper module, wrapper name, plain version)} of every
    kernel of F32_KERNELS (a bf16 entry point shares its wrapper)."""
    from fusiondepth_torch.kernels import conv3x3, knn, pool, reproj, warp

    return {
        "maxpool3x3s2": (pool, "maxpool3x3s2_fwd", pool.maxpool3x3s2_plain),
        "maxpool3x3s2_bwd": (pool, "maxpool3x3s2_bwd",
                             pool.maxpool3x3s2_bwd_plain),
        "conv3x3_reflect": (conv3x3, "conv3x3_reflect_fwd",
                            conv3x3.conv3x3_reflect_plain),
        "conv3x3_zero_act": (conv3x3, "conv3x3_zero_act_fwd",
                             conv3x3.conv3x3_zero_act_plain),
        "conv3x3_dgrad": (conv3x3, "conv3x3_dgrad",
                          conv3x3.conv3x3_dgrad_plain),
        "conv3x3_wgrad": (conv3x3, "conv3x3_wgrad",
                          conv3x3.conv3x3_wgrad_plain),
        "warp": (warp, "warp_fwd", warp.warp_plain),
        "warp_bwd": (warp, "warp_bwd", warp.warp_bwd_plain),
        "reproj": (reproj, "reproj_fwd", reproj.reproj_plain),
        "reproj_bwd": (reproj, "reproj_bwd", reproj.reproj_bwd_plain),
        "knn": (knn, "knn", knn.knn_plain),
    }


@contextlib.contextmanager
def all_plain(record=None):
    """Route every kernel wrapper to its plain version for the duration;
    with `record` (a list), also append (kernel, args, kwargs) of each
    call, tensor inputs cloned. Launches nothing."""
    table = wrappers()
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in table.items()}
    for name, (mod, attr, plain) in table.items():
        def stand_in(*args, _name=name, _plain=plain, **kwargs):
            if record is not None:
                data = args[DATA_ARG.get(_name, 0)]
                record.append((launch_key(_name, data.dtype)
                               if _name in BF16_KERNELS else _name,
                               [a.clone() if torch.is_tensor(a) else a
                                for a in args], dict(kwargs)))
            return _plain(*args, **kwargs)

        setattr(mod, attr, stand_in)
    try:
        yield
    finally:
        for name, (mod, attr, _) in table.items():
            setattr(mod, attr, saved[name])
