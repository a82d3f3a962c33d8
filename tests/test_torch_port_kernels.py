"""The port's kernel modules (fusiondepth_torch/kernels) against the JAX
package's Pallas kernels run in interpret mode, and their XLA references,
on the same numpy-made inputs, forward and backward (through jax.vjp). On
the CPU each wrapper takes its plain PyTorch version, so this holds the
plain versions (the reference the CUDA kernels are checked against on the
card by chip_smoke.py) to the TPU kernels' semantics.

Tolerances: the pool is a max, so exact, and its tie-splitting backward
divides the same values by the same counts (exact but for the order of at
most four additions: 1e-7); the convs sum at most 9 * 24 float32 products
in another order than the Pallas dots: atol 1e-5 for values and input
gradients, 1e-4 for the weight and bias gradients (sums over 512 pixels);
the warp against warp_planes_xla in float64: 1e-12; against the Pallas
kernel in float32: 1e-5; the reprojection loss against its Pallas kernel
in float32 (the bounds of tests/test_pallas_reproj.py): 5e-6 on the map,
5e-5 on the warped cotangent.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from fusiondepth_tpu.ops.folded import fold, unfold
from fusiondepth_tpu.ops.pallas_fold_conv import (
    fold_conv3x3_pallas,
    fold_conv3x3_zero_pallas,
)
from fusiondepth_tpu.ops.pallas_pool import max_pool_3x3s2_pallas
from fusiondepth_tpu.ops.pallas_reproj import reproj_loss_pallas
from fusiondepth_tpu.ops.planes import box3 as jax_box3
from fusiondepth_tpu.ops.pooling import _pool_even
from fusiondepth_tpu.ops.pooling import max_pool_3x3s2 as jax_pool
from fusiondepth_tpu.ops.warp import warp_planes as jax_warp_planes
from fusiondepth_tpu.ops.warp import warp_planes_xla
from fusiondepth_torch.kernels import LAUNCHES, build, conv3x3, knn, pool, \
    reproj, warp
from fusiondepth_torch.ops.pooling import max_pool_3x3s2
from fusiondepth_torch.ops.warp import warp_planes, warp_planes_plain

from test_torch_port_models import few_torch_threads  # noqa: F401


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


POOL_CASES = {
    "smooth": lambda r: r.standard_normal((2, 8, 16, 4)),
    # integer grid: dense ties inside the 3x3 windows
    "tied": lambda r: r.randint(0, 3, (2, 8, 32, 6)),
    "negative": lambda r: -r.uniform(1, 2, (1, 8, 16, 16)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_pallas_exactly(case):
    x = POOL_CASES[case](np.random.RandomState(0)).astype(np.float32)
    want = np.asarray(max_pool_3x3s2_pallas(jnp.asarray(x), True))
    got = _nhwc(max_pool_3x3s2(_nchw(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_pool(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(7, 9), (5, 6), (1, 3)])
def test_pool_odd_sizes_match_jax(hw):
    """floor((H + 2 - 3) / 2) + 1 rows for odd sizes too; JAX takes its
    generic path there."""
    x = np.random.RandomState(1).standard_normal(
        (1, *hw, 3)).astype(np.float32)
    got = _nhwc(max_pool_3x3s2(_nchw(x)))
    assert got.shape[1:3] == ((hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1)
    np.testing.assert_array_equal(got, np.asarray(jax_pool(jnp.asarray(x))))


def test_pool_propagates_nan_like_jnp_maximum():
    x = np.zeros((1, 8, 8, 1), np.float32)
    x[0, 7, 7, 0] = np.nan  # only the last window holds it
    got = _nhwc(pool.maxpool3x3s2(_nchw(x)))
    want = np.array(max_pool_3x3s2_pallas(jnp.asarray(x), True))
    assert np.isnan(got[0, 3, 3, 0]) and np.isnan(want[0, 3, 3, 0])
    got[0, 3, 3, 0] = want[0, 3, 3, 0] = 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("two_inputs", [False, True])
@pytest.mark.parametrize("elu", [True, False])
def test_reflect_conv_matches_pallas(two_inputs, elu):
    rng = np.random.RandomState(2)
    B, H, W, F = 2, 8, 32, 4
    C0, C1, Co = 16, (8 if two_inputs else 0), 12
    x0 = rng.standard_normal((B, H, W, C0)).astype(np.float32)
    x1 = rng.standard_normal((B, H, W, C1)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C0 + C1, Co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    ins = (fold(jnp.asarray(x0), F),)
    ks = (jnp.asarray(w[:, :, :C0]),)
    chs = (C0,)
    if two_inputs:
        ins += (fold(jnp.asarray(x1), F),)
        ks += (jnp.asarray(w[:, :, C0:]),)
        chs += (C1,)
    want = unfold(fold_conv3x3_pallas(ins, ks, jnp.asarray(b), F, chs, elu,
                                      True), Co)
    got = conv3x3.conv3x3_reflect(
        _nchw(x0), _oihw(w), torch.from_numpy(b),
        _nchw(x1) if two_inputs else None, elu)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("act", [False, True])
def test_zero_act_conv_matches_pallas(act):
    rng = np.random.RandomState(3)
    B, H, W, C, F = 2, 8, 32, 16, 2
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.2).astype(np.float32)
    s = (np.abs(rng.standard_normal(C)) * 0.5 + 0.5).astype(np.float32)
    # a positive shift makes relu(shift) != 0: a kernel that fed it to the
    # zero pad would disagree at every border pixel
    t = (np.abs(rng.standard_normal(C)) * 0.3 + 0.2).astype(np.float32)
    want = unfold(fold_conv3x3_zero_pallas(
        fold(jnp.asarray(x), F), jnp.asarray(w), jnp.tile(s, F),
        jnp.tile(t, F), F, C, act, True), C)
    scale = torch.from_numpy(s) if act else None
    shift = torch.from_numpy(t) if act else None
    got = conv3x3.conv3x3_zero_act(_nchw(x), _oihw(w), scale, shift)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cpu_path_launches_nothing():
    """Forward and backward of every wrapper on CPU tensors: plain
    versions only."""
    before = dict(LAUNCHES)
    x = torch.rand(1, 4, 8, 8, requires_grad=True)
    w = torch.rand(2, 8, 3, 3, requires_grad=True)
    s, t = torch.rand(4, requires_grad=True), torch.rand(4, requires_grad=True)
    out = (pool.maxpool3x3s2(x).sum()
           + conv3x3.conv3x3_reflect(x, w, torch.zeros(2, requires_grad=True),
                                     x).sum()
           + conv3x3.conv3x3_zero_act(x, w[:, :4], s, t).sum())
    coords = torch.rand(1, 2, 1, 8, 8, requires_grad=True)
    out = out + warp.warp(coords[:, :1] * 7, coords[:, 1:] * 7,
                          torch.rand(1, 1, 3, 8, 8)).sum()
    warped = torch.rand(2, 1, 1, 3, 8, 8, requires_grad=True)
    out = out + reproj.reproj_loss(warped, torch.rand(1, 3, 8, 8)).sum()
    out.backward()
    assert x.grad is not None and coords.grad is not None
    assert warped.grad is not None
    assert knn.knn(torch.rand(20, 3), 4).shape == (20, 4)
    assert LAUNCHES == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit, no fallback: the build raises."""
    monkeypatch.setenv("NVCC", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(tmp_path / "build")


def test_cuda_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    sent to the plain version."""
    x = torch.zeros(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        pool.maxpool3x3s2(x)
    w = torch.zeros(2, 4, 3, 3, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        conv3x3.conv3x3_reflect(x, w, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="expected cuda"):
        conv3x3.conv3x3_zero_act(x, w)
    # the backward wrappers
    y = torch.zeros(1, 4, 4, 4, device="meta")
    g = torch.zeros(1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        pool.maxpool3x3s2_bwd(x, y, y)
    with pytest.raises(ValueError, match="expected cuda"):
        conv3x3.conv3x3_dgrad(g, w, 4, reflect=True)
    with pytest.raises(ValueError, match="expected cuda"):
        conv3x3.conv3x3_wgrad(g, x, None, reflect=False)
    ix = torch.zeros(1, 1, 1, 8, 8, device="meta")
    src = torch.zeros(1, 1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        warp.warp(ix, ix, src)
    with pytest.raises(ValueError, match="expected cuda"):
        warp.warp_bwd(ix, ix, src, torch.zeros(1, 1, 1, 3, 8, 8,
                                                device="meta"))
    w6 = torch.zeros(2, 1, 1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        reproj.reproj_loss(w6, src[0])
    with pytest.raises(ValueError, match="expected cuda"):
        reproj.reproj_bwd(w6, src[0], torch.zeros(2, 1, 1, 8, 8,
                                                  device="meta"))
    with pytest.raises(ValueError, match="expected cuda"):
        knn.knn(torch.zeros(20, 3, device="meta"), 4)


# ---- backward kernels (plain versions) against the JAX VJPs ----

def test_pool_backward_splits_ties_like_jax():
    """Deliberately tied input: all-zero and constant windows (the pool's
    input is a ReLU output), and a few distinct maxima."""
    r = np.random.RandomState(4)
    x = np.maximum(r.randint(-2, 2, (2, 16, 12, 8)), 0).astype(np.float32)
    x[0, :4, :4] = 0.0
    x[1, 4:8] = 1.0
    x[0, 8, 6, 2] = 7.5
    g = r.standard_normal((2, 8, 6, 8)).astype(np.float32)
    _, vjp_even = jax.vjp(_pool_even, jnp.asarray(x))
    _, vjp_pallas = jax.vjp(
        jax.jit(lambda a: max_pool_3x3s2_pallas(a, True)), jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    max_pool_3x3s2(xt).backward(_nchw(g))
    got = _nhwc(xt.grad)
    for name, vjp in (("_pool_even", vjp_even), ("pallas", vjp_pallas)):
        np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                                   atol=1e-7, rtol=1e-6, err_msg=name)
    # mass is conserved per window: the gradient sums to the cotangent's sum
    np.testing.assert_allclose(got.sum(), g.sum(), rtol=1e-5)


def test_pool_backward_refuses_odd_sizes():
    x = torch.rand(1, 2, 7, 8, requires_grad=True)
    with pytest.raises(ValueError, match="even H and W"):
        max_pool_3x3s2(x).sum().backward()


@pytest.mark.parametrize("elu", [True, False])
def test_reflect_conv_backward_matches_pallas_vjp(elu):
    """Two inputs (the skip concat): dx per input, dW, db."""
    rng = np.random.RandomState(5)
    B, H, W, F = 2, 8, 32, 4
    C0, C1, Co = 16, 8, 12
    x0 = rng.standard_normal((B, H, W, C0)).astype(np.float32)
    x1 = rng.standard_normal((B, H, W, C1)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C0 + C1, Co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, H, W, Co)).astype(np.float32)

    def f(a0, a1, k, bias):
        return fold_conv3x3_pallas(
            (fold(a0, F), fold(a1, F)), (k[:, :, :C0], k[:, :, C0:]), bias,
            F, (C0, C1), elu, True)

    _, vjp = jax.vjp(jax.jit(f), jnp.asarray(x0), jnp.asarray(x1),
                     jnp.asarray(w), jnp.asarray(b))
    dx0, dx1, dw, db = (np.asarray(a) for a in vjp(fold(jnp.asarray(g), F)))
    t0, t1 = _nchw(x0).requires_grad_(True), _nchw(x1).requires_grad_(True)
    tw = _oihw(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    conv3x3.conv3x3_reflect(t0, tw, tb, t1, elu).backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(t0.grad), dx0, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_nhwc(t1.grad), dx1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.transpose(dw, (3, 2, 0, 1)), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), db, atol=1e-4, rtol=0)


@pytest.mark.parametrize("act", [False, True])
def test_zero_act_conv_backward_matches_pallas_vjp(act):
    """dx, dW and, with the act, d scale and d shift; a positive shift so
    that the pad taps (which stay 0) differ from relu(shift)."""
    rng = np.random.RandomState(6)
    B, H, W, C, F = 2, 8, 32, 16, 2
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.2).astype(np.float32)
    s = (np.abs(rng.standard_normal(C)) * 0.5 + 0.5).astype(np.float32)
    t = (np.abs(rng.standard_normal(C)) * 0.3 + 0.2).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)

    def f(a, k, sc, sh):
        return fold_conv3x3_zero_pallas(fold(a, F), k, jnp.tile(sc, F),
                                        jnp.tile(sh, F), F, C, act, True)

    _, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(v) for v in (x, w, s, t)))
    dx, dw, ds, dt = (np.asarray(a) for a in vjp(fold(jnp.asarray(g), F)))
    tx, tw = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    y = conv3x3.conv3x3_zero_act(tx, tw, ts if act else None,
                                 tt if act else None)
    y.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(tx.grad), dx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.transpose(dw, (3, 2, 0, 1)), atol=1e-4,
                               rtol=0)
    if act:
        np.testing.assert_allclose(ts.grad.numpy(), ds, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tt.grad.numpy(), dt, atol=1e-4, rtol=0)


def test_conv_backward_tiny_maps_match_autograd_f64():
    """2x2 reflect maps (every pixel a border pixel, corners folding twice)
    and 1x1 zero-pad maps: the Functions' backward against torch's autograd
    of the plain forward, in float64."""
    r = torch.Generator().manual_seed(0)
    for reflect, (B, C0, C1, Co, H, W) in ((True, (2, 3, 2, 4, 2, 2)),
                                           (True, (1, 5, 0, 3, 3, 5)),
                                           (False, (2, 4, 0, 3, 1, 1))):
        x0 = torch.randn(B, C0, H, W, generator=r, dtype=torch.float64)
        x1 = torch.randn(B, C1, H, W, generator=r,
                         dtype=torch.float64) if C1 else None
        w = torch.randn(Co, C0 + C1, 3, 3, generator=r, dtype=torch.float64)
        b = torch.randn(Co, generator=r, dtype=torch.float64)
        g = torch.randn(B, Co, H, W, generator=r, dtype=torch.float64)
        leaves = [v.requires_grad_(True) for v in (x0, w, b)
                  + ((x1,) if C1 else ())]
        if reflect:
            got = conv3x3.conv3x3_reflect(x0, w, b, x1, elu=True)
            want = conv3x3.conv3x3_reflect_plain(x0, w, b, x1, elu=True)
        else:
            s = torch.rand(C0, generator=r, dtype=torch.float64) + 0.5
            t = torch.rand(C0, generator=r, dtype=torch.float64) + 0.1
            leaves += [s.requires_grad_(True), t.requires_grad_(True)]
            got = conv3x3.conv3x3_zero_act(x0, w, s, t) + b[:, None, None]
            want = conv3x3.conv3x3_zero_act_plain(x0, w, s, t) + \
                b[:, None, None]
        ga = torch.autograd.grad(got, leaves, g)
        gw = torch.autograd.grad(want, leaves, g)
        for a, e in zip(ga, gw):
            torch.testing.assert_close(a, e, atol=1e-12, rtol=1e-12)


def _warp_case(n, k, B, C, H, W, spread, seed, dtype):
    r = np.random.RandomState(seed)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ix = jj[None, None, None] + r.uniform(-spread, spread, (n, k, B, H, W))
    iy = ii[None, None, None] + r.uniform(-spread / 3, spread / 3,
                                          (n, k, B, H, W))
    # normalized grid_sample coords, some beyond the border (clamped)
    grids = np.stack([(2 * ix + 1) / W - 1, (2 * iy + 1) / H - 1], -1)
    src = r.uniform(0, 1, (n, B, C, H, W))
    g = r.standard_normal((n, k, B, C, H, W))
    return grids.astype(dtype), src.astype(dtype), g.astype(dtype)


def test_warp_matches_xla_warp_and_its_vjp_f64():
    grids, src, g = _warp_case(2, 4, 2, 3, 12, 20, spread=6.0, seed=7,
                               dtype=np.float64)
    with jax.enable_x64():
        want, vjp = jax.vjp(warp_planes_xla, jnp.asarray(src),
                            jnp.asarray(grids))
        dgrid = np.asarray(vjp(jnp.asarray(g))[1])
        want = np.asarray(want)
    tg = torch.from_numpy(grids).requires_grad_(True)
    got = warp_planes(torch.from_numpy(src), tg)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(tg.grad.numpy(), dgrid, atol=1e-12, rtol=0)
    # the other TPU backend selects the same kernel; the plain dispatch
    # (torch autograd through the gathers) agrees
    tg2 = torch.from_numpy(grids).requires_grad_(True)
    warp_planes(torch.from_numpy(src), tg2, backend="gather").backward(
        torch.from_numpy(g))
    assert torch.equal(tg2.grad, tg.grad)
    tg3 = torch.from_numpy(grids).requires_grad_(True)
    warp_planes_plain(torch.from_numpy(src), tg3).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(tg3.grad.numpy(), dgrid, atol=1e-12)


def test_warp_matches_pallas_banded_kernel_in_band():
    """Near-identity flow inside the TPU kernel's band (|dx| <= 12 px),
    H a multiple of 16, through the JAX dispatch with the Pallas kernel in
    interpret mode: the kernel is exact there. Gradients to the grids, so
    coordinates clamped at the border get none on either side."""
    grids, src, g = _warp_case(2, 2, 1, 3, 32, 128, spread=12.0, seed=8,
                               dtype=np.float32)
    want, vjp = jax.vjp(jax.jit(lambda gr: jax_warp_planes(
        jnp.asarray(src), gr, use_pallas=True, interpret=True)),
        jnp.asarray(grids))
    dgrid = np.asarray(vjp(jnp.asarray(g))[0])
    tg = torch.from_numpy(grids).requires_grad_(True)
    got = warp_planes(torch.from_numpy(src), tg)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg.grad.numpy(), dgrid, atol=1e-5, rtol=1e-5)


def test_warp_refuses_sources_that_need_grad():
    ix = torch.zeros(1, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="sources get no gradient"):
        warp.warp(ix, ix, torch.zeros(1, 1, 3, 4, 4, requires_grad=True))


# ---- the fused reprojection loss (plain version) against its Pallas kernel

def _reproj_data(shape=(2, 2, 1, 3, 48, 128)):
    """tests/test_pallas_reproj.py's data."""
    rng = np.random.RandomState(0)
    n, k, B, C, H, W = shape
    warped = rng.rand(n, k, B, C, H, W).astype(np.float32)
    target = rng.rand(B, C, H, W).astype(np.float32)
    return warped, target


def _pallas_reproj(warped, target):
    t = jnp.asarray(target)
    return lambda w: reproj_loss_pallas(w, t, jax_box3(t), jax_box3(t * t),
                                        True)


def test_reproj_matches_pallas_kernel_and_its_vjp():
    warped, target = _reproj_data()
    want, vjp = jax.vjp(jax.jit(_pallas_reproj(warped, target)),
                        jnp.asarray(warped))
    w = torch.from_numpy(warped).requires_grad_(True)
    got = reproj.reproj_loss(w, torch.from_numpy(target))
    assert got.shape == want.shape == (2, 2, 1, 48, 128)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-6, rtol=0)
    g = np.random.RandomState(1).standard_normal(want.shape).astype(
        np.float32)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(vjp(g)[0]),
                               atol=5e-5, rtol=0)
    assert np.array_equal(
        reproj.reproj_bwd(torch.from_numpy(warped), torch.from_numpy(target),
                          torch.from_numpy(g)).numpy(), w.grad.numpy())


def test_reproj_identity_call_matches_pallas_kernel():
    """The automask call: the sources as a k=1 candidate axis."""
    warped, target = _reproj_data()
    sources = warped[:, 0]
    want = _pallas_reproj(sources, target)(jnp.asarray(sources[:, None]))
    got = reproj.reproj_loss(torch.from_numpy(sources[:, None].copy()),
                             torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6,
                               rtol=0)


def test_reproj_refuses_what_the_kernel_does_not_take():
    """Shapes the kernel cannot take are refused before any launch: a
    1-pixel side (no reflect padding) and a target that does not fit."""
    w = torch.zeros(1, 1, 2, 3, 1, 8, device="meta")
    with pytest.raises(ValueError, match="H, W >= 2"):
        reproj._check("reproj", w, torch.zeros(2, 3, 1, 8, device="meta"))
    with pytest.raises(ValueError, match="does not fit"):
        reproj._check("reproj", torch.zeros(1, 1, 2, 3, 4, 8),
                      torch.zeros(1, 3, 4, 8))
    with pytest.raises(ValueError, match="no gradient"):
        reproj.reproj_loss(torch.zeros(1, 1, 1, 3, 4, 8),
                           torch.zeros(1, 3, 4, 8, requires_grad=True))


# ---- the conv kernels' 3xTF32 arithmetic and their tile choice ----

def _tf32_reference(x32):
    """cvt.rna.tf32.f32 from the values, in float64: |x| to the nearest
    multiple of its TF32 spacing (2^(e - 10) for |x| in [2^e, 2^(e+1)),
    2^-136 below 2^-126), ties away from zero; the sign kept (also of 0);
    past the largest TF32 to inf by the float32 cast; inf and NaN as
    they are."""
    with np.errstate(invalid="ignore"):  # signalling NaNs
        x = x32.astype(np.float64)
    a = np.abs(x)
    _, e = np.frexp(np.where(np.isfinite(a) & (a > 0), a, 1.0))
    spacing = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    r = np.copysign(np.floor(a / spacing + 0.5) * spacing, x)
    with np.errstate(over="ignore"):
        return np.where(np.isfinite(x), r, x).astype(np.float32)


def test_tf32_round_matches_a_bit_level_reference():
    """Ties away from zero, round-ups into the next binade (and past the
    largest TF32 to inf), +-0, +-inf, NaN, subnormals, and random bit
    patterns over the whole float32 range."""
    b = np.float32
    ulp = 2.0 ** -10  # of [1, 2)
    cases = [1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
             1 + ulp / 2 - 2 ** -23, 2 - ulp / 2, -(2 - ulp / 4), 0.0, -0.0,
             np.inf, -np.inf, np.nan,
             2.0 ** -149, 2.0 ** -137, -(2.0 ** -137), 3 * 2.0 ** -138,
             np.finfo(b).max, -np.finfo(b).max]
    special = np.array(cases, np.float64).astype(b)
    bit_cases = np.array([0x7F7FE000, 0x007FFFFF, 0x80001000, 0x00001000,
                          0x3F800FFF, 0x7F800001], np.uint32).view(b)
    rand = np.random.RandomState(7).randint(0, 2 ** 32, 4096,
                                            dtype=np.uint64)
    x = np.concatenate([special, bit_cases,
                        rand.astype(np.uint32).view(b)])
    got = conv3x3.tf32_round(torch.from_numpy(x)).numpy()
    want = _tf32_reference(x)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    # the named cases
    assert got[0] == 1 + ulp and got[1] == -(1 + ulp) and got[2] == 1 + 2 * ulp
    assert got[3] == 1.0 and got[4] == 2.0 and got[5] == -2.0
    assert np.signbit(got[7]) and got[8] == np.inf and got[9] == -np.inf
    assert got[11] == 0.0 and got[12] == 2.0 ** -136
    assert np.isinf(got[15]) and got[len(special)] == bit_cases[0]
    assert got[len(special) + 1] == 2.0 ** -126  # subnormal -> normal


def _split(t):
    big = conv3x3.tf32_round(t)
    return big, conv3x3.tf32_round(t - big)


def _three_tf32(op, a, b):
    """op(a, b) with both operands split as the kernels split them: the
    small products first, each product exact in float32, summed in
    float32."""
    (ab, a_s), (bb, bs) = _split(a), _split(b)
    return op(a_s, bb) + op(ab, bs) + op(ab, bb)


def _one_tf32(op, a, b):
    return op(conv3x3.tf32_round(a), conv3x3.tf32_round(b))


def test_3xtf32_conv_is_fp32_accurate_and_1xtf32_is_not():
    """The kernels' arithmetic emulated on the plain versions' operands. A
    layer1-like forward (Ci = Co = 64, 576 products per output) lands
    within chip_smoke's CONV_TOL (1e-4 abs + 1e-4 rel) of float64, and a
    weight gradient over 9984 pixels within its WGRAD_REL (1e-3 of the
    largest magnitude); one TF32 product, on the same data, misses both.
    The wgrad data are a BN-like input (offset 0.25, spread 0.02) and a
    per-channel zero-mean cotangent, as a conv ahead of a BatchNorm gets:
    dW is then a small difference of large sums, and the input's low
    mantissa bits, which one TF32 product drops, carry it."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((2, 64, 12, 20))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 64, 3, 3)) / 24)
                         .astype(np.float32))

    def conv(a, k):
        return F.conv2d(a, k, padding=1)

    want = conv(x.double(), w.double())
    for emulate, ok in ((_three_tf32, True), (_one_tf32, False)):
        got = emulate(conv, x, w).double()
        assert bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4)) is ok

    xw = torch.from_numpy((0.25 + 0.02 * rng.standard_normal((2, 4, 48, 104)))
                          .astype(np.float32))
    g = rng.standard_normal((2, 4, 48, 104))
    g = torch.from_numpy((g - g.mean((0, 2, 3), keepdims=True))
                         .astype(np.float32))

    def wgrad(gg, a):
        return torch.nn.grad.conv2d_weight(a, (4, 4, 3, 3), gg, padding=1)

    want = wgrad(g.double(), xw.double())
    for emulate, ok in ((_three_tf32, True), (_one_tf32, False)):
        err = (emulate(wgrad, g, xw).double() - want).abs().max()
        assert bool(err <= 1e-3 * want.abs().max()) is ok


def _path_convs():
    """(B, H, W, Ci, Co, reflect) of every 3x3 conv kernel call of the
    batch-12 train step and the batch-4 refine step at 640x192 (each call
    also runs its dgrad and wgrad when it is trained), read from the
    models: layer1's fused blocks of the four ResNet-18 encoders (the
    pose encoders take both frame pairs, 2B images) at H/4, and every
    ConvBlock of the stage-1 depth decoder and of the refine2d decoder at
    its level (upconv_i_0 at level i + 1, upconv_i_1 and dispconv_i at
    level i)."""
    from fusiondepth_torch.config import Config
    from fusiondepth_torch.models.depth_decoder import ConvBlock, DepthDecoder
    from fusiondepth_torch.models.resnet import (RESNET_FEATURE_CHANNELS,
                                                 BasicBlock, ResnetEncoder)

    cfg = Config(num_layers=18, height=192, width=640)
    H, W = cfg.height, cfg.width
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        layer1 = [(m.conv1.weight.shape, m.conv2.weight.shape)
                  for m in ResnetEncoder(18).modules()
                  if isinstance(m, BasicBlock) and m.fused]
    ch = RESNET_FEATURE_CHANNELS[18]
    decoders = (DepthDecoder(ch, scales=cfg.scales),
                DepthDecoder(ch, scales=cfg.scales, road=True,
                             catxy=cfg.catxy, deep=cfg.refine2d_deep,
                             generator=gen))
    calls = set()
    for B, decs in ((12, decoders[:1]), (4, decoders)):
        for n in (B, B, 2 * B, 2 * B):  # RGB, beam and the pose encoders
            for shapes in layer1:
                for co, ci, _, _ in shapes:
                    calls.add((n, H // 4, W // 4, ci, co, False))
        for dec in decs:
            for name, m in dec.named_modules():
                if isinstance(m, ConvBlock):
                    # "upconv_4_0", "upconv_4_0.a", "dispconv_3"
                    kind, level, *j = name.split(".")[0].split("_")
                    lv = int(level) + (kind == "upconv" and j == ["0"])
                    co, ci = m.conv.weight.shape[:2]
                    calls.add((B, H >> lv, W >> lv, ci, co, True))
    return sorted(calls)


def test_conv_tiles_fit_every_conv_of_the_main_paths():
    """Every tile and split that conv_tiles picks for the convs of the b12
    train step and the b4 refine step is one the kernels take, every
    wgrad run holds at least one pixel tile, and every wgrad grid fills
    at least one wave of the H100's 132 SMs."""
    calls = _path_convs()
    # layer1 at b12, b24, b4, b8; stage 1's 14 and refine2d's 24 convs
    assert len(calls) >= 4 + 14
    assert any(ci % conv3x3.CHUNK for _, _, _, ci, _, _ in calls)  # K tails
    assert any(co == 1 for *_, co, _ in calls)  # the heads: N tails
    for B, H, W, Ci, Co, reflect in calls:
        t = conv3x3.conv_tiles(B, H, W, Ci, Co, reflect)
        assert t.fwd_n in conv3x3.N_TILES and t.dgrad_n in conv3x3.N_TILES
        assert t.fwd_n <= max(conv3x3.N_TILES[0], 2 * Co)  # no wider
        assert t.wgrad_mw in (1, 2, 4) and t.wgrad_splits >= 1
        # the kernel's runs: ceil(n_pix / splits) tiles each, none empty
        n_pix = B * conv3x3.pixel_tiles(H, W, conv3x3.WGRAD_TILE_H)
        per_split = -(-n_pix // t.wgrad_splits)
        assert (t.wgrad_splits - 1) * per_split < n_pix
        blocks = (-(-Co // (16 * t.wgrad_mw))
                  * -(-Ci // conv3x3.WGRAD_CI[t.wgrad_mw]) * t.wgrad_splits)
        assert blocks >= conv3x3.N_SMS, (B, H, W, Ci, Co)
