"""3x3 stride-1 convolutions of the depth path, NCHW, weights OIHW, with
their backward kernels.

Kernels: `csrc/conv3x3.cu`, which replaces the TPU kernels of
`fusiondepth_tpu/ops/pallas_fold_conv.py`:

- `conv3x3_reflect_fwd`: `_run_conv` as driven by `fold_conv3x3_pallas`,
  the decoder's ConvBlock / Conv3x3 head: reflect pad addressed in the
  kernel, a virtual concat of one or two inputs, bias, optional ELU;
- `conv3x3_zero_act_fwd`: `_run_conv` as driven by
  `fold_conv3x3_zero_pallas`, the encoder basic-block conv: zero pad, no
  bias, with the preceding BN affine + ReLU optionally applied to in-bounds
  input taps;
- `conv3x3_dgrad`: the dgrad use of `_run_conv` in `_bwd` and `_zbwd`,
  d(input) for both pads, split over the two inputs;
- `conv3x3_wgrad`: `_run_wgrad`, d(weight) for both pads and the act.

`conv3x3_reflect` and `conv3x3_zero_act` are the differentiable ops, each
an autograd Function over these kernels. What JAX leaves to XLA stays in
tensor ops here: the ELU derivative from the saved output, the bias
gradient and the backward of the act (dx, d scale, d shift).

The conv kernels are implicit GEMMs on the tensor cores with 3xTF32
products (each operand split into two TF32 parts, three products per
multiply-add, fp32 accumulation: fp32-accurate; see the note at the top of
the source). `conv_tiles` picks their tiles per call, and `tf32_round` is
their TF32 rounding in tensor ops, for the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda_f32, \
    on_card
from fusiondepth_torch.ops.padding import reflect_pad_hw


# The kernels' tiles (csrc/conv3x3.cu): a forward block covers 8 x 32
# output pixels and takes 8 input channels per K chunk; a wgrad block
# sums pixel tiles of 2 x 32 for 16 mw output channels and WGRAD_CI[mw]
# input channels. N_SMS: the H100's streaming multiprocessors.
TILE_H, TILE_W, CHUNK = 8, 32, 8
WGRAD_TILE_H = 2
WGRAD_CI = {1: 32, 2: 32, 4: 16}
N_SMS = 132
N_TILES = (8, 16, 32, 64)
# blocks wanted in a grid: the forward holds <= 85 KB of shared memory a
# block and the wgrad <= 101 KB, so two blocks of either fit on an SM
GRID_BLOCKS = 2 * N_SMS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pixel_tiles(H: int, W: int, rows: int = TILE_H) -> int:
    """Pixel tiles of `rows` x TILE_W over an H x W map."""
    return _cdiv(H, rows) * _cdiv(W, TILE_W)


def n_tile(B: int, H: int, W: int, Co: int) -> int:
    """The forward kernel's N tile (output channels per block) for a
    (B, Co, H, W) output: the narrowest of N_TILES that covers Co (64 at
    most), halved while the grid would give fewer than GRID_BLOCKS
    blocks."""
    n = next((t for t in N_TILES if t >= Co), N_TILES[-1])
    while n > N_TILES[0] and \
            B * pixel_tiles(H, W) * _cdiv(Co, n) < GRID_BLOCKS:
        n //= 2
    return n


@dataclass(frozen=True)
class ConvTiles:
    """The kernels' per-call choice for a 3x3 conv of a (B, Ci, H, W) input
    into Co channels: `fwd_n` the forward's N tile, `dgrad_n` the dgrad's
    (over the Ci outputs, on the padded (H + 2, W + 2) domain with the
    reflect pad), `wgrad_mw` the wgrad block's 16 mw output channels and
    `wgrad_splits` the runs of its 2 x 32 pixel tiles that the wgrad sums
    apart (the kernel gives each ceil(tiles / splits) tiles, the last run
    fewer)."""
    fwd_n: int
    dgrad_n: int
    wgrad_mw: int
    wgrad_splits: int


def conv_tiles(B: int, H: int, W: int, Ci: int, Co: int,
               reflect: bool = False) -> ConvTiles:
    """Tiles and splits of the three conv kernels for one call (see
    ConvTiles). The wgrad block takes as many output channels as Co fills
    (16, 32 or 64); its pixel tiles are cut into contiguous runs so that
    the grid holds about GRID_BLOCKS blocks, none of them empty."""
    pad = 2 if reflect else 0
    mw = 4 if Co > 32 else (2 if Co > 16 else 1)
    pairs = _cdiv(Co, 16 * mw) * _cdiv(Ci, WGRAD_CI[mw])
    n_pix = B * pixel_tiles(H, W, WGRAD_TILE_H)
    want = min(max(1, _cdiv(GRID_BLOCKS, pairs)), n_pix)
    return ConvTiles(fwd_n=n_tile(B, H, W, Co),
                     dgrad_n=n_tile(B, H + pad, W + pad, Ci), wgrad_mw=mw,
                     wgrad_splits=_cdiv(n_pix, _cdiv(n_pix, want)))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """The kernels' `cvt.rna.tf32.f32` in torch bit operations: each
    float32 rounded to 10 mantissa bits, to nearest with ties away from
    zero (the low 13 bits cleared); subnormals alike, a finite value past
    the largest TF32 to +-inf, NaN stays NaN. The kernels split every
    operand x into tf32_round(x) and tf32_round(x - tf32_round(x)).
    Nothing on the main path calls it; it documents that arithmetic."""
    t = t.to(torch.float32)
    bits = (t.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(t.isnan(), t, bits.view(torch.float32))


def _concat(x0, x1):
    return x0 if x1 is None else torch.cat([x0, x1], 1)


def conv3x3_reflect_plain(x0, weight, bias, x1=None, elu: bool = True):
    """Plain version: ReflectionPad2d(1) over cat([x0, x1]), conv, ELU."""
    y = F.conv2d(reflect_pad_hw(_concat(x0, x1), 1), weight, bias)
    return F.elu(y) if elu else y


def conv3x3_zero_act_plain(x, weight, scale=None, shift=None):
    """Plain version: conv3x3(relu(x * scale + shift), zero pad 1), or
    conv3x3(x) without scale/shift."""
    if scale is not None:
        x = torch.relu(x * scale[:, None, None] + shift[:, None, None])
    return F.conv2d(x, weight, padding=1)


def reflect_pad_adjoint(gp: torch.Tensor) -> torch.Tensor:
    """Adjoint of ReflectionPad2d(1): (B, C, H + 2, W + 2) over padded
    positions -1..H, -1..W -> (B, C, H, W). Padded row -1 adds into row 1
    and row H into row H-2, then the same for columns (corners fold
    twice)."""
    gp = gp.clone()
    gp[:, :, 2] += gp[:, :, 0]
    gp[:, :, -3] += gp[:, :, -1]
    gp[:, :, :, 2] += gp[:, :, :, 0]
    gp[:, :, :, -3] += gp[:, :, :, -1]
    return gp[:, :, 1:-1, 1:-1]


def _split(dx, C0):
    return dx[:, :C0], (dx[:, C0:] if dx.shape[1] > C0 else None)


def conv3x3_dgrad_plain(g, weight, C0: int, reflect: bool):
    """Plain version of the dgrad kernel: (dx0, dx1) of the conv with
    `weight` (Co, C0 + C1, 3, 3) from its cotangent g (B, Co, H, W), split
    at input channel C0 (dx1 is None when C1 is 0)."""
    if reflect:
        return _split(reflect_pad_adjoint(F.conv_transpose2d(g, weight)), C0)
    return _split(F.conv_transpose2d(g, weight, padding=1), C0)


def _padded_input(x0, x1, reflect, scale, shift):
    x = _concat(x0, x1)
    if scale is not None:
        x = torch.relu(x * scale[:, None, None] + shift[:, None, None])
    return reflect_pad_hw(x, 1) if reflect else F.pad(x, (1, 1, 1, 1))


def conv3x3_wgrad_plain(g, x0, x1, reflect: bool, scale=None, shift=None):
    """Plain version of the wgrad kernel: dW (Co, C0 + C1, 3, 3) of the conv
    over the padded virtual concat of x0 and x1 (relu(x * scale + shift) on
    in-bounds taps when given, the zero pad staying 0), from g."""
    xp = _padded_input(x0, x1, reflect, scale, shift)
    Ci = xp.shape[1]
    return torch.nn.grad.conv2d_weight(xp, (g.shape[1], Ci, 3, 3), g)


def _check_shapes(name, x0, x1, weight, min_hw):
    if x0.dim() != 4 or 0 in x0.shape:
        raise ValueError(f"{name}: expected non-empty (B, C, H, W) input, "
                         f"got {tuple(x0.shape)}")
    B, C0, H, W = x0.shape
    if H < min_hw or W < min_hw:
        raise ValueError(f"{name}: H and W must be >= {min_hw}, got {H}x{W}")
    C1 = 0
    if x1 is not None:
        if x1.dim() != 4 or x1.shape[0] != B or x1.shape[2:] != x0.shape[2:]:
            raise ValueError(f"{name}: x1 {tuple(x1.shape)} does not match "
                             f"x0 {tuple(x0.shape)}")
        C1 = x1.shape[1]
    if weight.shape[1:] != (C0 + C1, 3, 3):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not fit "
                         f"{C0 + C1} input channels")
    return B, C0, C1, H, W, weight.shape[0]


def conv3x3_reflect_fwd(x0: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, x1: Optional[torch.Tensor] = None,
                        elu: bool = True) -> torch.Tensor:
    """Reflect-pad 3x3 conv over the channel concat of x0 (B, C0, H, W) and
    optional x1 (B, C1, H, W), weight (Co, C0 + C1, 3, 3), bias (Co,),
    ELU when `elu`. CPU tensors take the plain version; CUDA tensors take
    the kernel (float32, contiguous), which never builds the concat."""
    if x0.device.type == "cpu":
        return conv3x3_reflect_plain(x0, weight, bias, x1, elu)
    name = "conv3x3_reflect"
    check_cuda_f32(name, x0=x0, x1=x1, weight=weight, bias=bias)
    B, C0, C1, H, W, Co = _check_shapes(name, x0, x1, weight, min_hw=2)
    if bias.shape != (Co,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)}, expected ({Co},)")
    y = torch.empty((B, Co, H, W), device=x0.device, dtype=torch.float32)
    with on_card(x0) as stream:
        build.check(build.load().fd_conv3x3_reflect_fwd(
            x0.data_ptr(), C0, None if x1 is None else x1.data_ptr(), C1,
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B, H, W, Co,
            int(elu), n_tile(B, H, W, Co), stream),
            "fd_conv3x3_reflect_fwd")
    LAUNCHES[name] += 1
    return y


def conv3x3_zero_act_fwd(x: torch.Tensor, weight: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Zero-pad bias-free 3x3 conv of x (B, C, H, W) with weight
    (Co, C, 3, 3); with scale/shift (C,), of relu(x * scale + shift) with
    the pad still 0. CPU tensors take the plain version; CUDA tensors take
    the kernel (float32, contiguous)."""
    if (scale is None) != (shift is None):
        raise ValueError("conv3x3_zero_act: give both scale and shift or "
                         "neither")
    if x.device.type == "cpu":
        return conv3x3_zero_act_plain(x, weight, scale, shift)
    name = "conv3x3_zero_act"
    check_cuda_f32(name, x=x, weight=weight, scale=scale, shift=shift)
    B, C, _, H, W, Co = _check_shapes(name, x, None, weight, min_hw=1)
    if scale is not None and (scale.shape != (C,) or shift.shape != (C,)):
        raise ValueError(f"{name}: scale/shift must be ({C},)")
    y = torch.empty((B, Co, H, W), device=x.device, dtype=torch.float32)
    with on_card(x) as stream:
        build.check(build.load().fd_conv3x3_zero_act_fwd(
            x.data_ptr(), C, weight.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            y.data_ptr(), B, H, W, Co, n_tile(B, H, W, Co), stream),
            "fd_conv3x3_zero_act_fwd")
    LAUNCHES[name] += 1
    return y


def conv3x3_dgrad(g: torch.Tensor, weight: torch.Tensor, C0: int,
                  reflect: bool):
    """(dx0, dx1): d(input) of a 3x3 conv with `weight` (Co, C0 + C1, 3, 3)
    from the cotangent g (B, Co, H, W), split at input channel C0 (dx1 is
    None when C1 is 0); reflect or zero pad. CPU tensors take the plain
    version; CUDA tensors take the kernel (float32, contiguous)."""
    if g.device.type == "cpu":
        return conv3x3_dgrad_plain(g, weight, C0, reflect)
    name = "conv3x3_dgrad"
    check_cuda_f32(name, g=g, weight=weight)
    if g.dim() != 4 or 0 in g.shape or weight.shape[0] != g.shape[1] \
            or weight.shape[2:] != (3, 3) or not 0 < C0 <= weight.shape[1]:
        raise ValueError(f"{name}: g {tuple(g.shape)}, weight "
                         f"{tuple(weight.shape)}, C0 {C0} do not fit")
    B, Co, H, W = g.shape
    C1 = weight.shape[1] - C0
    if reflect and (H < 2 or W < 2):
        raise ValueError(f"{name}: reflect pad needs H, W >= 2")
    if not reflect and C1:
        raise ValueError(f"{name}: the zero-pad conv has one input")
    wt = weight.flip(2, 3).transpose(0, 1).contiguous()
    opts = dict(device=g.device, dtype=torch.float32)
    dx0 = torch.empty((B, C0, H, W), **opts)
    dx1 = torch.empty((B, C1, H, W), **opts) if C1 else None
    dxp = torch.empty((B, C0 + C1, H + 2, W + 2), **opts) if reflect \
        else None
    with on_card(g) as stream:
        build.check(build.load().fd_conv3x3_dgrad(
            g.data_ptr(), Co, wt.data_ptr(),
            None if dxp is None else dxp.data_ptr(), dx0.data_ptr(), C0,
            None if dx1 is None else dx1.data_ptr(), C1, B, H, W,
            int(reflect), conv_tiles(B, H, W, C0 + C1, Co, reflect).dgrad_n,
            stream), "fd_conv3x3_dgrad")
    LAUNCHES[name] += 1
    return dx0, dx1


def conv3x3_wgrad(g: torch.Tensor, x0: torch.Tensor,
                  x1: Optional[torch.Tensor], reflect: bool,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW (Co, C0 + C1, 3, 3) of a 3x3 conv over the reflect- or zero-padded
    virtual concat of x0 and x1 (with scale/shift: relu(x0 * scale + shift)
    on in-bounds taps, zero pad only), from its cotangent g (B, Co, H, W).
    CPU tensors take the plain version; CUDA tensors take the kernel
    (float32, contiguous)."""
    if (scale is None) != (shift is None) or (scale is not None and
                                              (reflect or x1 is not None)):
        raise ValueError("conv3x3_wgrad: scale and shift come together, "
                         "with the zero-pad single-input conv")
    if x0.device.type == "cpu":
        return conv3x3_wgrad_plain(g, x0, x1, reflect, scale, shift)
    name = "conv3x3_wgrad"
    check_cuda_f32(name, g=g, x0=x0, x1=x1, scale=scale, shift=shift)
    B, C0, H, W = x0.shape
    C1 = 0 if x1 is None else x1.shape[1]
    if g.dim() != 4 or g.shape[0] != B or g.shape[2:] != x0.shape[2:] or (
            x1 is not None and (x1.shape[0] != B or
                                x1.shape[2:] != x0.shape[2:])):
        raise ValueError(f"{name}: g {tuple(g.shape)} and inputs do not fit "
                         f"x0 {tuple(x0.shape)}")
    if scale is not None and (scale.shape != (C0,) or shift.shape != (C0,)):
        raise ValueError(f"{name}: scale/shift must be ({C0},)")
    if reflect and (H < 2 or W < 2):
        raise ValueError(f"{name}: reflect pad needs H, W >= 2")
    Co, Ci = g.shape[1], C0 + C1
    tiles = conv_tiles(B, H, W, Ci, Co, reflect)
    part = torch.empty((tiles.wgrad_splits, Co, Ci, 9), device=g.device,
                       dtype=torch.float32)
    dw = torch.empty((Co, Ci, 3, 3), device=g.device, dtype=torch.float32)
    with on_card(g) as stream:
        build.check(build.load().fd_conv3x3_wgrad(
            g.data_ptr(), Co, x0.data_ptr(), C0,
            None if x1 is None else x1.data_ptr(), C1,
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), part.data_ptr(),
            dw.data_ptr(), B, H, W, int(reflect), tiles.wgrad_mw,
            tiles.wgrad_splits, stream), "fd_conv3x3_wgrad")
    LAUNCHES[name] += 1
    return dw


class _ConvReflect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x1, weight, bias, elu):
        y = conv3x3_reflect_fwd(x0, weight, bias, x1, elu)
        ctx.save_for_backward(x0, x1, weight, y if elu else None)
        ctx.elu = elu
        return y

    @staticmethod
    def backward(ctx, g):
        x0, x1, weight, y = ctx.saved_tensors
        g = g.contiguous()
        if ctx.elu:  # ELU'(z) = 1 for z > 0, else exp(z) = y + 1
            g = g * torch.where(y > 0, 1.0, y + 1.0)
        need_x0, need_x1, need_w, need_b, _ = ctx.needs_input_grad
        dx0 = dx1 = dw = db = None
        if need_x0 or need_x1:
            dx0, dx1 = conv3x3_dgrad(g, weight, x0.shape[1], reflect=True)
        if need_w:
            dw = conv3x3_wgrad(g, x0, x1, reflect=True)
        if need_b:
            db = g.sum((0, 2, 3))
        return dx0, dx1, dw, db, None


class _ConvZeroAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, scale, shift):
        y = conv3x3_zero_act_fwd(x, weight, scale, shift)
        ctx.save_for_backward(x, weight, scale, shift)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, scale, shift = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_s, need_t = ctx.needs_input_grad
        dx = dw = ds = dt = None
        if need_x or need_s or need_t:
            da, _ = conv3x3_dgrad(g, weight, x.shape[1], reflect=False)
            if scale is None:
                dx = da
            else:  # d of relu(x * s + t), as _zbwd leaves it to XLA
                pre = x * scale[:, None, None] + shift[:, None, None]
                da = torch.where(pre > 0, da, 0.0)
                dx = da * scale[:, None, None]
                ds = (da * x).sum((0, 2, 3))
                dt = da.sum((0, 2, 3))
        if need_w:
            dw = conv3x3_wgrad(g, x, None, reflect=False, scale=scale,
                               shift=shift)
        return dx, dw, ds, dt


def conv3x3_reflect(x0: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, x1: Optional[torch.Tensor] = None,
                    elu: bool = True) -> torch.Tensor:
    """Reflect-pad 3x3 conv over the channel concat of x0 and x1, bias, ELU
    when `elu` (see conv3x3_reflect_fwd), differentiable in every tensor:
    on a card the forward, dgrad and wgrad kernels run."""
    return _ConvReflect.apply(x0, x1, weight, bias, elu)


def conv3x3_zero_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-pad 3x3 conv of x, or of relu(x * scale + shift) (see
    conv3x3_zero_act_fwd), differentiable in every tensor: on a card the
    forward, dgrad and wgrad kernels run."""
    if (scale is None) != (shift is None):
        raise ValueError("conv3x3_zero_act: give both scale and shift or "
                         "neither")
    return _ConvZeroAct.apply(x, weight, scale, shift)
