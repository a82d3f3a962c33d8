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

`all_plain` routes every wrapper to its plain version for a while (the
all-plain steps that `chip_smoke.py` and `bench.py` compare and count
against).
"""

from __future__ import annotations

import contextlib

import torch

LAUNCHES = {"maxpool3x3s2": 0, "maxpool3x3s2_bwd": 0, "conv3x3_reflect": 0,
            "conv3x3_zero_act": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0,
            "warp": 0, "warp_bwd": 0, "reproj": 0, "reproj_bwd": 0,
            "knn": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def on_card(x: torch.Tensor):
    """Make x's card the current one for a launch and yield the handle of
    its current stream; the caller's current card is restored after."""
    with torch.cuda.device(x.device):
        yield torch.cuda.current_stream().cuda_stream


def check_cuda_f32(name: str, **tensors) -> None:
    """Raise unless every given tensor is a contiguous float32 CUDA tensor
    on one device (None entries are skipped)."""
    devices = set()
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            "float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def wrappers():
    """{kernel: (wrapper module, wrapper name, plain version)} of every
    kernel in LAUNCHES."""
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
                record.append((_name, [a.clone() if torch.is_tensor(a)
                                       else a for a in args], dict(kwargs)))
            return _plain(*args, **kwargs)

        setattr(mod, attr, stand_in)
    try:
        yield
    finally:
        for name, (mod, attr, _) in table.items():
            setattr(mod, attr, saved[name])
