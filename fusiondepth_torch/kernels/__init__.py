"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
launch counts.

Each wrapper takes its plain version for a tensor on the CPU (the tests run
there) and launches its kernel for a CUDA tensor, or raises; it never falls
back from the kernel to the plain version. A wrapper adds one to its entry
in `LAUNCHES` each time it launches its kernel, so a run can show that it
went through the kernels (see `chip_smoke.py`).
"""

from __future__ import annotations

import contextlib

import torch

LAUNCHES = {"maxpool3x3s2": 0, "conv3x3_reflect": 0, "conv3x3_zero_act": 0}


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
    on one device (None entries are skipped). The kernels are forward-only:
    a tensor that would need a gradient is refused too."""
    devices = set()
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name}: the kernel has no backward yet; call it under "
                "torch.no_grad() or torch.inference_mode()")
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
