"""compute_dtype="bfloat16" in the port (fusiondepth_torch) against the
JAX package's bf16 path, on the CPU.

The JAX side runs its generic path (its TPU layout flags off,
test_torch_port_models.GENERIC; the Pallas kernels are TPU-only there and
the CPU takes their XLA counterparts) in bfloat16 at B=2, 64x96, ResNet-18,
with the weights carried to the port by models/jax_weights and the inputs
made from a numpy seed. bf16 rounds at other places in the two
frameworks (XLA fuses elementwise chains and may keep their intermediate
values in float32; the port's kernels and their plain versions compute in
float32 and round once at their outputs, as the Pallas kernels do), so
the tolerances are in units of bf16's unit roundoff U = 2^-8, and where
they depend on the noise of bf16 itself they are measured against the
JAX package's own float32 path:

- the stem pool forward and backward: bit-equal;
- BatchNorm, train and eval: the output within 2 U of the magnitudes of
  its terms |x A| + |Bc|; the batch statistics within 1e-6;
- the reflect ConvBlock (+ ELU) and the zero-pad conv with its BN + ReLU
  prologue: within 2 U |y| + 2 U S, S the summed magnitudes of the
  products (and the bias) that an output sums;
- the warp and its grid gradient, the fused reprojection map and its
  warped cotangent: within a stated number of U of the JAX output's
  scale;
- forward_depth: every scale's disparities within DISP_BF16_ATOL of the
  JAX bf16 ones, and both within 2x the JAX package's own bf16-vs-float32
  distance of its float32 disparities;
- one train step: the loss within 1e-2 relative of the JAX bf16 loss, or
  within 2x the JAX package's own bf16-vs-float32 distance where that is
  larger (its SSIM maps take box means rounded to bf16, which biases them
  up; the port's are float32 inside, as the CUDA kernel's), and closer to
  the float32 loss than the JAX bf16 loss is; both within 5% of the
  float32 loss (tests/test_loss_planes.py:91). Every gradient leaf within
  2x its bf16 noise of the JAX bf16 leaf: the noise is the largest
  relative L2 distance of JAX bf16 to JAX float32 on that leaf over
  1 + NOISE_DRAWS draws of the bf16 roundings (the batch, and the batch
  with its images nudged by one bf16 step, `nudged`), at least 1e-3; the
  port's distance is its RMS over the same draws. One draw is not enough:
  the bf16 geometry leaves the photometric cotangent of a disparity map
  ~100% off float32 pixel by pixel in both packages, so a head's bias
  (one number, the sum of those cotangents) moves by 0.3-7% from one draw
  to the next. BN statistics: within 2x their noise on the batch; one
  Adam step: by lr at most, within 2 lr of the JAX update. The
  parameters, BN statistics and Adam moments stay float32.
"""

import concurrent.futures

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.models.depth_decoder import ConvBlock as JaxConvBlock
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.models.norm import BatchNorm as JaxBatchNorm
from fusiondepth_tpu.ops.pallas_reproj import reproj_loss_pallas
from fusiondepth_tpu.ops.planes import box3 as jax_box3
from fusiondepth_tpu.ops.pooling import max_pool_3x3s2 as jax_pool
from fusiondepth_tpu.ops.warp import warp_planes_xla
from fusiondepth_tpu.training.train_state import (
    combine_variables,
    make_loss_fn,
    make_optimizer as jax_make_optimizer,
    split_variables,
)
from fusiondepth_torch.config import Config
from fusiondepth_torch.kernels import conv3x3, pool, reproj
from fusiondepth_torch.models.depth_decoder import ConvBlock
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import NETS, from_jax_variables, \
    to_jax_variables
from fusiondepth_torch.models.norm import BatchNorm
from fusiondepth_torch.ops.planes import box3
from fusiondepth_torch.ops.warp import warp_planes
from fusiondepth_torch.training.eval_driver import predict_disparities
from fusiondepth_torch.training.infer_driver import Infer, device_batch
from fusiondepth_torch.training.train_state import loss_fn, \
    make_optimizer, train_step
from fusiondepth_torch.training.trainer import TRAIN_KEYS

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jax_sides_in_threads, jit, \
    random_variables
from test_torch_port_train import _leaves, make_inputs

B, H, W = 2, 64, 96
U = 2.0 ** -8  # bf16's unit roundoff
BF16 = torch.bfloat16
CPU = torch.device("cpu")
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          weights_init="scratch")
STEPS_PER_EPOCH = 10
SRC = (-1, 1)
WARP_FWD_U, WARP_BWD_U = 1.0, 1.0
DISP_BF16_ATOL = 0.05
GRAD_NOISE_FLOOR = 1e-3
# bf16 draws of the JAX step besides the batch itself (`nudged`), whose
# largest distance to float32 is a leaf's noise
NOISE_DRAWS = 4
REPROJ_FWD_U, REPROJ_BWD_U = 2.0, 2.0


def bf16_np(a):
    """numpy float32 values rounded to bf16 (as float32), so that both
    sides start from the same bf16 inputs."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def t16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)


def j16(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def f32(x):
    """A port tensor or JAX array as float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def value_and_vjp(f):
    """(f(x, *rest), the VJP of f in x at the cotangent g), as one function
    of (x, g, *rest) to jit."""
    def run(x, g, *rest):
        y, vjp = jax.vjp(lambda v: f(v, *rest), x)
        return y, vjp(g)[0]
    return run


# ---- modules ----

def test_stem_pool_forward_and_backward_bit_equal():
    """The stem pool's plain versions (the CUDA kernels' function) against
    the JAX pool and its tie-splitting VJP, in bf16: ties are frequent
    (ReLU zeros and values equal after rounding)."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((B, 32, 48, 16)), 0)  # NHWC
    g = rng.standard_normal((B, 16, 24, 16))
    y_j, dx_j = jit(value_and_vjp(jax_pool))(j16(x), j16(g))
    xt = t16(np.moveaxis(x, -1, 1)).contiguous()
    y_p = pool.maxpool3x3s2_plain(xt)
    dx_p = pool.maxpool3x3s2_bwd_plain(xt, y_p,
                                       t16(np.moveaxis(g, -1, 1)).contiguous())
    assert y_p.dtype == dx_p.dtype == BF16
    np.testing.assert_array_equal(np.moveaxis(f32(y_p), 1, -1), f32(y_j))
    np.testing.assert_array_equal(np.moveaxis(f32(dx_p), 1, -1), f32(dx_j))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_bf16(train):
    """Statistics in float32 over the bf16 input, A and Bc in float32 then
    cast (fusiondepth_tpu/models/norm.py:48-94)."""
    rng = np.random.default_rng(1)
    C = 24
    x = bf16_np(rng.standard_normal((B, 8, 12, C)) * 2 + 0.5)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                    "bias": rng.standard_normal(C).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(C).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}
    jbn = JaxBatchNorm(use_running_average=not train, dtype=jnp.bfloat16)
    y_j, upd = jbn.apply(v, j16(x), mutable=["batch_stats"])
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    bn.train(train)
    xt = t16(np.moveaxis(x, -1, 1))
    with torch.no_grad():
        a, b = bn.affine(xt) if not train else (None, None)
        y_p = bn(xt)
    assert y_p.dtype == BF16
    assert bn.running_mean.dtype == torch.float32
    # the terms' magnitudes, from the affine the port used (eval) or the
    # one its batch statistics give
    if train:
        bn2 = BatchNorm(C)
        bn2.load_state_dict(bn.state_dict())
        bn2.eval()
        acc = xt.float()
        mean, var = acc.mean((0, 2, 3)), (acc * acc).mean((0, 2, 3))
        var = (var - mean * mean).clamp_min(0)
        inv = torch.rsqrt(var + 1e-5) * bn.weight.detach()
        a, b = inv, bn.bias.detach() - mean * inv
    scale = (xt.float().abs() * a.float().abs()[:, None, None]
             + b.float().abs()[:, None, None]).numpy()
    err = np.abs(np.moveaxis(f32(y_p), 1, -1) - f32(y_j))
    assert (err <= 2 * U * np.moveaxis(scale, 1, -1)).all(), err.max()
    if train:
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   atol=1e-6, rtol=0)


def _conv_bound(y_p, y_j, summands):
    err = np.abs(f32(y_p) - y_j)
    bound = 2 * U * np.abs(y_j) + 2 * U * summands
    assert (err <= bound).all(), (err.max(), (err / bound).max())
    return float((err / bound).max())


def test_conv_block_reflect_bf16():
    """The decoder's ConvBlock (reflect pad, conv, bias, ELU) on a skip
    concat of two inputs: the port's plain version (float32 sums from bf16
    operands, float32 bias and ELU, one rounding) against the JAX
    ConvBlock's bf16 conv + bias + ELU."""
    rng = np.random.default_rng(2)
    C0, C1, Co = 16, 8, 12
    x0 = bf16_np(rng.standard_normal((B, 10, 14, C0)))
    x1 = bf16_np(rng.standard_normal((B, 10, 14, C1)))
    k = rng.standard_normal((3, 3, C0 + C1, Co)).astype(np.float32) * 0.2
    bias = rng.standard_normal(Co).astype(np.float32) * 0.1
    v = {"params": {"conv": {"kernel": k, "bias": bias}}}
    y_j = f32(JaxConvBlock(Co, dtype=jnp.bfloat16).apply(
        v, j16(np.concatenate([x0, x1], -1))))
    blk = ConvBlock(C0 + C1, Co)
    with torch.no_grad():
        blk.conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        blk.conv.bias.copy_(torch.from_numpy(bias))
        y_p = blk(t16(np.moveaxis(x0, -1, 1)), t16(np.moveaxis(x1, -1, 1)))
    assert y_p.dtype == BF16
    # summed magnitudes of the products, ELU'ed bound: ELU is 1-Lipschitz
    xa = torch.from_numpy(np.abs(np.moveaxis(np.concatenate([x0, x1], -1),
                                             -1, 1))).double()
    from fusiondepth_torch.ops.padding import reflect_pad_hw
    s = torch.nn.functional.conv2d(reflect_pad_hw(xa, 1),
                                   torch.from_numpy(np.abs(k).transpose(
                                       3, 2, 0, 1)).double(),
                                   torch.from_numpy(np.abs(bias)).double())
    _conv_bound(np.moveaxis(f32(y_p), 1, -1), y_j,
                np.moveaxis(s.numpy(), 1, -1))


def test_zero_pad_conv_with_bn_relu_prologue_bf16():
    """The encoder's fused conv: conv3x3(relu(x * A + Bc)), zero pad, A and
    Bc in bf16 (pallas_fold_conv.py:598), against the JAX generic
    relu(BN affine) then bf16 nn.Conv."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    C, Co = 16, 16
    x = bf16_np(rng.standard_normal((B, 10, 14, C)))
    A = bf16_np(rng.uniform(0.5, 1.5, C))
    Bc = bf16_np(rng.standard_normal(C) * 0.3)
    k = rng.standard_normal((3, 3, C, Co)).astype(np.float32) * C ** -0.5
    act = jnp.maximum(j16(x) * j16(A) + j16(Bc), 0)
    y_j = f32(nn.Conv(Co, (3, 3), padding=1, use_bias=False,
                      dtype=jnp.bfloat16).apply({"params": {"kernel": k}},
                                                act))
    y_p = conv3x3.conv3x3_zero_act_plain(
        t16(np.moveaxis(x, -1, 1)), t16(k.transpose(3, 2, 0, 1)), t16(A),
        t16(Bc))
    assert y_p.dtype == BF16
    xa = np.abs(np.maximum(x * A + Bc, 0))
    s = torch.nn.functional.conv2d(
        torch.from_numpy(np.moveaxis(xa, -1, 1)).double(),
        torch.from_numpy(np.abs(k).transpose(3, 2, 0, 1)).double(),
        padding=1)
    _conv_bound(np.moveaxis(f32(y_p), 1, -1), y_j,
                np.moveaxis(s.numpy(), 1, -1))


def _warp_inputs(rng):
    n, k, C = 2, 2, 3
    src = bf16_np(rng.uniform(0, 1, (n, B, C, 16, 24)))
    base = np.stack(np.meshgrid(np.linspace(-1, 1, 24),
                                np.linspace(-1, 1, 16), indexing="xy"), -1)
    grids = bf16_np(base[None, None, None]
                    + rng.uniform(-0.3, 0.3, (n, k, B, 16, 24, 2)))
    g = bf16_np(rng.standard_normal((n, k, B, C, 16, 24)))
    return src, grids, g


def test_warp_planes_and_grid_gradient_bf16():
    """bf16 sources and grids: the port's warp (the grid widened to
    float32, the sample in float32, one rounding) against the JAX XLA warp
    (warp_planes_xla, which accumulates in float32 the same way), forward
    and grid gradient."""
    src, grids, g = _warp_inputs(np.random.default_rng(4))
    y_j, dg_j = jit(value_and_vjp(lambda gr, s: warp_planes_xla(s, gr)))(
        j16(grids), j16(g), j16(src))
    gr = t16(grids).requires_grad_(True)
    y_p = warp_planes(t16(src), gr)
    y_p.backward(t16(g))
    assert y_p.dtype == BF16 and gr.grad.dtype == BF16
    err = np.abs(f32(y_p) - f32(y_j))
    assert err.max() <= WARP_FWD_U * U, err.max() / U
    derr = np.abs(f32(gr.grad) - f32(dg_j))
    assert derr.max() <= WARP_BWD_U * U * np.abs(f32(dg_j)).max(), \
        derr.max() / U / np.abs(f32(dg_j)).max()


def test_warp_grid_gradient_on_the_border_halves_as_jnp_clip():
    """A coordinate exactly on the image border: the JAX warp clips it with
    jnp.clip, whose gradient there is halved (max and min split a tie);
    the port clipped with torch.clamp, which passed all of it. bf16 grids
    land on the border often (-1 + 1/H is a bf16 value at H = 64). Float64
    on both sides: before the repair the port's grid gradient was twice
    the JAX one on such pixels."""
    rng = np.random.default_rng(7)
    n, k, C, Hs, Ws = 1, 1, 2, 8, 16
    src = rng.uniform(0, 1, (n, B, C, Hs, Ws))
    grids = rng.uniform(-0.9, 0.9, (n, k, B, Hs, Ws, 2))
    grids[..., :4, 0] = -1 + 1 / Ws        # ix == 0
    grids[..., -4:, 1] = 1 - 1 / Hs        # iy == H - 1
    g = rng.standard_normal((n, k, B, C, Hs, Ws))
    with jax.enable_x64():
        _, want = jit(value_and_vjp(lambda gr, s: warp_planes_xla(s, gr)))(
            jnp.asarray(grids), jnp.asarray(g), jnp.asarray(src))
        want = np.asarray(want)
    gr = torch.from_numpy(grids).requires_grad_(True)
    warp_planes(torch.from_numpy(src), gr).backward(torch.from_numpy(g))
    np.testing.assert_allclose(gr.grad.numpy(), want, rtol=1e-12,
                               atol=1e-12)


def test_reprojection_map_and_cotangent_bf16():
    """The fused SSIM + L1 map's plain version in bf16 (the moments in
    float32, the map and the warped cotangent rounded once) against the
    JAX package's fused Pallas kernel in interpret mode on the same bf16
    warped and target, handed the target's box means in float32 as the
    CUDA kernel computes them (the JAX wrapper rounds them to bf16)."""
    rng = np.random.default_rng(5)
    n, k, C, Hs, Ws = 2, 1, 3, 32, 40
    t = bf16_np(rng.uniform(0, 1, (B, C, Hs, Ws)))
    w = bf16_np(np.clip(t[None, None] + rng.normal(0, 0.1, (n, k, B, C, Hs,
                                                             Ws)), 0, 1))
    g = bf16_np(rng.standard_normal((n, k, B, Hs, Ws)))
    tj = jnp.asarray(t)
    muy, ey2 = jax_box3(tj), jax_box3(tj * tj)
    y_j, dw_j = jit(value_and_vjp(lambda wv, tv, m, e: reproj_loss_pallas(
        wv, tv, m, e, True)))(j16(w), j16(g), j16(t), muy, ey2)
    wt = t16(w)
    y_p = reproj.reproj_plain(wt, t16(t))
    dw_p = reproj.reproj_bwd_plain(wt, t16(t), t16(g))
    assert y_p.dtype == dw_p.dtype == BF16
    err = np.abs(f32(y_p) - f32(y_j))
    assert (err <= REPROJ_FWD_U * U * np.abs(f32(y_j)) + 1e-6).all(), \
        (err / np.maximum(np.abs(f32(y_j)), 1e-6)).max() / U
    derr = np.abs(f32(dw_p) - f32(dw_j))
    assert derr.max() <= REPROJ_BWD_U * U * np.abs(f32(dw_j)).max(), \
        derr.max() / U / np.abs(f32(dw_j)).max()


def test_box3_bf16_rounds_as_jax_default_precision():
    """ops/planes.py::box3 on a bf16 map: the taps times bf16(1/3), float32
    sums, a bf16 rounding after each pass, as the JAX box3's two bf16
    matmuls at Precision.DEFAULT with float32 accumulation."""
    x = bf16_np(np.random.default_rng(6).uniform(0, 1, (3, 2, 12, 20)))
    np.testing.assert_array_equal(f32(box3(t16(x))), f32(jax_box3(j16(x))))


def test_loss_kinks_take_the_jax_derivatives():
    """Where warped == target, or neighbouring disparities are equal (both
    common under bf16), the L1 and smoothness gradients follow jnp.abs
    (+1 at 0), as the JAX package's do; torch.abs would give 0 there.
    Float64 on both sides."""
    from fusiondepth_tpu.ops import planes as jplanes
    from fusiondepth_torch.ops import planes

    rng = np.random.default_rng(8)
    disp = rng.uniform(0.1, 1, (B, 8, 12))
    disp[:, 2:6, 3:9] = 0.5
    img = rng.uniform(0, 1, (B, 3, 8, 12))
    pred = rng.uniform(0, 1, (2, B, 3, 8, 12))
    pred[..., :4, :] = img[None, ..., :4, :]
    g = rng.standard_normal((2, B, 8, 12))
    with jax.enable_x64():
        want_d = np.asarray(jit(jax.grad(
            jplanes.normalized_smoothness_planes))(jnp.asarray(disp),
                                                   jnp.asarray(img)))
        _, want_p = jit(value_and_vjp(
            lambda p, t: jplanes.reprojection_loss_planes(
                p, t[None], use_ssim=False)))(
            jnp.asarray(pred), jnp.asarray(g), jnp.asarray(img))
        want_p = np.asarray(want_p)
    d = torch.from_numpy(disp).requires_grad_(True)
    planes.normalized_smoothness_planes(d, torch.from_numpy(img)).backward()
    p = torch.from_numpy(pred).requires_grad_(True)
    planes.reprojection_loss_planes(p, torch.from_numpy(img)[None],
                                    False).backward(torch.from_numpy(g))
    np.testing.assert_allclose(d.grad.numpy(), want_d, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), want_p, rtol=1e-10,
                               atol=1e-12)


def test_bf16_trainer_checkpoint_converts_to_the_jax_bf16_config(tmp_path):
    """A bf16 Trainer's saved weights are float32 (the parameters and BN
    statistics never leave float32), and scripts/convert_checkpoint.py
    to-jax gives the JAX package's load_checkpoint under its bf16 Config
    the same parameters and statistics, bit for bit."""
    import importlib.util
    import os

    from fusiondepth_tpu.training.checkpoint import \
        load_checkpoint as jax_load_checkpoint
    from fusiondepth_tpu.training.train_state import TrainState
    from fusiondepth_torch.data.synthetic import SyntheticDataset
    from fusiondepth_torch.training.trainer import Trainer

    cfg = Config(**KW, compute_dtype="bfloat16", beam_encoder=False,
                 log_dir=str(tmp_path), num_workers=1, log_frequency=1)
    trainer = Trainer(cfg, train_dataset=SyntheticDataset(cfg, length=2),
                      device=CPU)
    assert len(trainer.run_epoch()) == 1
    src = trainer.save("bf16")
    saved = torch.load(os.path.join(src, "model.pt"), map_location="cpu")
    floats = [v for v in saved.values() if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)

    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "convert_checkpoint.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    dst = str(tmp_path / "jax" / "weights_bf16")
    assert script.main(["to-jax", src, dst]) == 0

    jcfg = JaxConfig(**KW, compute_dtype="bfloat16", beam_encoder=False)
    shapes = jax.eval_shape(lambda: JaxFusionNets(jcfg).init(
        jax.random.PRNGKey(0), batch_size=B))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = split_variables(zeros)
    tx = jax_make_optimizer(jcfg, 1)
    opt = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                       jax.eval_shape(tx.init, params))
    state, meta = jax_load_checkpoint(
        dst, TrainState(params, stats, opt, jnp.asarray(0, jnp.int32)))
    assert meta["step"] == trainer.step == 1
    want = to_jax_variables(trainer.nets.state_dict())
    got_p = dict(_leaves(jax.tree.map(np.asarray, state.params)))
    got_s = dict(_leaves(jax.tree.map(np.asarray, {
        k: v for k, v in state.batch_stats.items() if v})))
    want_p = dict(_leaves({k: v["params"] for k, v in want.items()}))
    want_s = dict(_leaves({k: v["batch_stats"] for k, v in want.items()
                           if "batch_stats" in v}))
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    for k in want_p:
        assert got_p[k].dtype == np.float32, k
        np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)
    for k in want_s:
        np.testing.assert_array_equal(got_s[k], want_s[k], err_msg=k)


# ---- the slice: forward_depth and one train step ----

def jax_config(compute_dtype):
    return JaxConfig(**KW, compute_dtype=compute_dtype, pallas_warp=False,
                     **GENERIC)


def jax_bf16_side():
    """The JAX package's forward_depth (eval) and one train step (loss,
    gradients, BN statistics, one Adam update) in bfloat16 and in
    float32, from the same float32 weights and batch."""
    batch = {k: v.astype(np.float32) for k, v in make_inputs().items()}
    init = JaxFusionNets(jax_config("float32"))
    v = random_variables(lambda: init.init(jax.random.PRNGKey(0),
                                           batch_size=B),
                         np.random.default_rng(0), np.float32)
    params, stats = split_variables(v)
    key = jax.random.PRNGKey(42)
    batches = [batch] + [nudged(batch, s) for s in range(NOISE_DRAWS)]
    out = dict(variables={k: v[k] for k in NETS if k in v}, batch=batch)

    def one_dtype(dt):
        cfg = jax_config(dt)
        nets = JaxFusionNets(cfg)
        loss_f = make_loss_fn(cfg, nets)
        tx = jax_make_optimizer(cfg, STEPS_PER_EPOCH)

        def run(params, stats, batch, key):
            (loss, (_, new_stats)), grads = jax.value_and_grad(
                loss_f, has_aux=True)(params, stats, batch, key)
            updates, _ = tx.update(grads, tx.init(params), params)
            fwd = nets.forward_depth(combine_variables(params, stats), batch,
                                     train=False)[0]
            return (fwd, loss, grads, new_stats,
                    optax.apply_updates(params, updates))

        step = jit(run)
        fwd, loss, grads, new_stats, new_params = jax.tree.map(
            f32, step(params, stats, jnp_batch(batch), key))
        draws = [jax.tree.map(f32, step(params, stats, jnp_batch(b),
                                        key)[2:4]) for b in batches[1:]]
        return dict(fwd=fwd, loss=float(loss), new_params=new_params,
                    draws=[(grads, new_stats)] + draws)

    # the two steps trace, compile and run in two threads at once (XLA's
    # compile releases the GIL): the fixture's time is the slower one's
    dtypes = ("bfloat16", "float32")
    with concurrent.futures.ThreadPoolExecutor(len(dtypes)) as pool:
        out.update(zip(dtypes, pool.map(one_dtype, dtypes)))
    noise, r = [], key
    for _ in range(4):
        r, sub = jax.random.split(r)
        noise.append(torch.from_numpy(np.asarray(jax.random.normal(
            sub, (len(SRC), B, H, W))) * 1e-5))
    out["noise"] = noise
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_bf16_sides():
    """`jax_bf16_side` under way in a thread from the module's first test
    on (`JaxSides`; under pytest-xdist from the first test that reads
    it), while the module tests and the checkpoint test run."""
    with jax_sides_in_threads(side=lambda sides: jax_bf16_side()) as sides:
        yield sides


@pytest.fixture(scope="module")
def jax_side(jax_bf16_sides):
    return jax_bf16_sides["side"].result()


def jnp_batch(batch):
    return {k: jnp.asarray(x) for k, x in batch.items()}


def nudged(batch, seed):
    """The batch with every value of the images and the 2-channel LiDAR
    moved by one bf16 step up or down at random: another draw of the bf16
    roundings of the same step, for each encoder."""
    rng = np.random.default_rng(100 + seed)
    return {k: (v * (1 + U * rng.choice([-1.0, 1.0], v.shape)).astype(
        np.float32) if k.startswith("color") or k == "two_channel" else v)
        for k, v in batch.items()}


def port_nets(jax_side):
    nets = FusionNets(Config(**KW, compute_dtype="bfloat16"), device=CPU)
    nets.load_state_dict(from_jax_variables(jax_side["variables"]))
    return nets


def test_forward_depth_bf16_matches_jax(jax_side):
    """forward_depth in bf16 (eval BN): every scale within DISP_BF16_ATOL
    of the JAX bf16 disparities, and the port's and the JAX package's
    bf16 disparities both within 2x the JAX package's own bf16-vs-float32
    distance of its float32 ones. Infer and predict_disparities serve
    the same bf16 disparities, as float32 arrays."""
    nets = port_nets(jax_side)
    db = device_batch(jax_side["batch"], CPU)
    with torch.no_grad():
        out, _ = nets.forward_depth(db)
    for k, want16 in jax_side["bfloat16"]["fwd"].items():
        want32 = jax_side["float32"]["fwd"][k]
        got = out[k]
        assert got.dtype == BF16, k
        got = f32(got)
        d_jax = np.abs(want16 - want32).max()
        d_port = np.abs(got - want32).max()
        d = np.abs(got - want16).max()
        print(k, "port-jax16", d, "port-jax32", d_port, "jax16-jax32", d_jax)
        assert d <= DISP_BF16_ATOL, (k, d)
        assert d_port <= 2 * d_jax, (k, d_port, d_jax)
    served = Infer(nets.cfg, device=CPU, nets=nets).infer(db)
    assert torch.equal(served, out[("disp", 0)])
    frames = [{k: v[i] for k, v in jax_side["batch"].items()
               if k in ("color_aug", "two_channel", "four_beam")}
              for i in range(B)]
    disps, _ = predict_disparities(nets.cfg.replace(eval_batch_size=B),
                                   frames, nets=nets)
    assert all(d.dtype == np.float32 for d in disps)
    np.testing.assert_array_equal(np.stack(disps), f32(served)[..., 0])


def draw(nets, grads):
    """(gradient leaves, BN-statistics leaves) in the JAX package's tree
    layout, from the port's gradients and its nets after the step."""
    sd = to_jax_variables(nets.state_dict())
    return (dict(_leaves({k: v["params"] for k, v in
                          to_jax_variables(grads).items()})),
            dict(_leaves({k: v["batch_stats"] for k, v in sd.items()
                          if "batch_stats" in v})))


def port_draw(jax_side, batch):
    """`draw` of the port's bf16 loss on `batch`: its gradients and the
    BN statistics its training-mode forward leaves (no update)."""
    nets = port_nets(jax_side)
    loss, _ = loss_fn(nets.cfg, nets, device_batch(batch, CPU, TRAIN_KEYS,
                                                   torch.float32),
                      noise=jax_side["noise"])
    loss.backward()
    return draw(nets, {n: p.grad for n, p in nets.named_parameters()})


def jax_draw(tree):
    grads, stats = tree
    return (dict(_leaves(grads)),
            dict(_leaves({k: v for k, v in stats.items() if v})))


def within_noise(ports, j16s, j32s):
    """Per leaf: (leaf, the port's RMS relative L2 distance to the JAX bf16
    leaf over the draws, the leaf's noise, the limit)."""
    rows = []
    for k in j16s[0]:
        noise = max(_rel_l2(a[k], b[k]) for a, b in zip(j16s, j32s))
        dist = float(np.sqrt(np.mean([_rel_l2(p[k], a[k]) ** 2
                                      for p, a in zip(ports, j16s)])))
        rows.append((k, dist, noise, 2 * max(noise, GRAD_NOISE_FLOOR)))
    return rows


def _rel_l2(a, b):
    return float(np.linalg.norm((np.asarray(a, np.float64) - b).ravel())
                 / max(np.linalg.norm(np.asarray(b, np.float64).ravel()),
                       1e-30))


def test_bf16_train_step_matches_jax(jax_side):
    """One train_step in bf16 against make_loss_fn's bf16 loss and
    gradients, the BN statistics it updates and the Adam update; the
    tolerances of the module docstring. Parameters, BN statistics and
    Adam's moments stay float32; the gradients arrive float32."""
    nets = port_nets(jax_side)
    cfg = nets.cfg
    opt, sched = make_optimizer(cfg, nets, STEPS_PER_EPOCH)
    before = {n: p.detach().clone() for n, p in nets.named_parameters()}
    losses = train_step(cfg, nets, opt, sched,
                        device_batch(jax_side["batch"], CPU, TRAIN_KEYS,
                                     torch.float32),
                        noise=jax_side["noise"])
    j16, j32 = jax_side["bfloat16"], jax_side["float32"]
    loss = float(losses["loss"])
    # the JAX bf16 loss's own distance to its float32 loss: its SSIM maps
    # take box means rounded to bf16 (planes.py's box3), which biases them
    # up; the port's take them in float32, as the CUDA kernel does
    noise = abs(j16["loss"] - j32["loss"])
    print("loss", loss, j16["loss"], j32["loss"])
    assert abs(loss - j16["loss"]) <= max(1e-2 * abs(j16["loss"]),
                                          2 * noise)
    assert abs(loss - j32["loss"]) <= noise
    for got in (loss, j16["loss"]):
        assert abs(got - j32["loss"]) <= 0.05 * abs(j32["loss"])

    assert all(p.dtype == torch.float32 for p in nets.parameters())
    assert all(b.dtype == torch.float32 for b in nets.buffers())
    assert all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
               for s in opt.state.values())
    grads = {n: p.grad for n, p in nets.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               for g in grads.values())

    # the gradients and BN statistics on the batch and on the same nudged
    # draws as the JAX package's (those without an update)
    ports = [draw(nets, grads)] + [
        port_draw(jax_side, nudged(jax_side["batch"], s))
        for s in range(NOISE_DRAWS)]
    j16s = [jax_draw(d) for d in j16["draws"]]
    j32s = [jax_draw(d) for d in j32["draws"]]
    for i, what in enumerate(("gradient", "BN statistics")):
        assert ports[0][i].keys() == j16s[0][i].keys()
        rows = within_noise([p[i] for p in ports], [a[i] for a in j16s],
                            [b[i] for b in j32s])
        bad = [r for r in rows if r[1] > r[3]]
        print(what, len(rows), "leaves; the worst (leaf, distance, noise, "
              "limit):", sorted(rows, key=lambda r: -r[1] / r[3])[:4],
              "; noise over 0.1:", sum(r[2] > 0.1 for r in rows))
        assert not bad, (what, bad[:5])

    # Adam's first step moves each parameter by lr * g / (|g| + eps):
    # by lr at most, and within 2 lr of the JAX update (the two agree
    # where the gradients' signs do), in float32 on float32 parameters
    lr = opt.param_groups[0]["lr"]
    new = dict(_leaves({k: v["params"] for k, v in
                        to_jax_variables(nets.state_dict()).items()}))
    old = dict(_leaves({k: v["params"] for k, v in
                        to_jax_variables(before).items()}))
    for k, want in dict(_leaves(j16["new_params"])).items():
        ulp = np.spacing(np.abs(old[k]).astype(np.float32))  # p's rounding
        assert (np.abs(new[k] - old[k]) <= lr * (1 + 1e-5) + ulp).all(), k
        assert (np.abs(new[k] - want) <= 2 * (lr * (1 + 1e-5) + ulp)).all(), k


