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

import importlib.util
import re
from pathlib import Path

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
    grids, src, g = _warp_case(1, 2, 1, 3, 16, 128, spread=12.0, seed=8,
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
    batch-12 train step and the batch-4 refine step at 640x192 and of the
    batch-4 completion step at 1216x352 (each call also runs its dgrad and
    wgrad when it is trained), read from the models: layer1's fused blocks
    of the ResNet-18 encoders (the pose encoders take both frame pairs, 2B
    images; the completion step's R50 depth and beam encoders have no
    fused block) at H/4, and every ConvBlock of the stage-1 depth decoder
    (R18 widths, and R50 widths for completion) and of the refine2d
    decoder at its level (upconv_i_0 at level i + 1, upconv_i_1 and
    dispconv_i at level i)."""
    from fusiondepth_torch.config import Config
    from fusiondepth_torch.models.depth_decoder import ConvBlock, DepthDecoder
    from fusiondepth_torch.models.resnet import (RESNET_FEATURE_CHANNELS,
                                                 BasicBlock, ResnetEncoder)

    cfg = Config(num_layers=18, height=192, width=640)
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
    completion = DepthDecoder(RESNET_FEATURE_CHANNELS[50], scales=cfg.scales)
    # (B, H, W, the images of each R18 encoder, the decoders): RGB, beam
    # and the two pose encoders; completion's two R18 pose encoders
    steps = ((12, 192, 640, (12, 12, 24, 24), decoders[:1]),
             (4, 192, 640, (4, 4, 8, 8), decoders),
             (4, 352, 1216, (8, 8), (completion,)))
    calls = set()
    for B, H, W, images, decs in steps:
        for n in images:
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
    train step, the b4 refine step and the b4 completion step is one the
    kernels take, every wgrad run holds at least one pixel tile, and every
    wgrad grid fills at least one wave of the H100's 132 SMs."""
    calls = _path_convs()
    # layer1 at b12, b24, b4, b8; stage 1's 14 and refine2d's 24 convs
    assert len(calls) >= 4 + 14
    # completion: the R50 decoder's stride-32 map, 11 x 38 (H odd, W no
    # multiple of the forward's 32-pixel tile), its 2048 + 1024 = 3072
    # input channels there (upconv_4_1 takes 256 + 1024 skip), and the
    # scale-0 convs at 352 x 1216
    assert (4, 11, 38, 2048, 256, True) in calls
    assert any(c[:3] == (4, 352, 1216) for c in calls)
    assert (8, 88, 304, 64, 64, False) in calls
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


# ---- the pool and reprojection backward kernels' schedules, modelled ----
# The CUDA kernels cannot run here; these hold the arithmetic of their tile
# schedules, written in torch ops with the kernels' own tile constants, to
# the plain versions that chip_smoke.py holds the kernels to on the card.

def _cu_constants(source, *names):
    """The `constexpr int` values `names` of kernels/csrc/`source`."""
    text = (build.CSRC / source).read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names]


def _pool_bwd_tiled(x, y, g):
    """maxpool3x3s2_bwd_kernel's schedule in float32: per tile of TH x TW
    windows, x staged with its one-window halo (pads -inf), y (NaN past
    the image) and g of (TH + 1) x (TW + 1) windows; pass 1 divides g by
    each window's tie count over its 9 staged taps; pass 2 gives each
    2 x 2 quad of input pixels its windows' gc where x == y, in the plain
    scatter's (dy, dx) order."""
    TH, TW = _cu_constants("maxpool3x3s2.cu", "PB_TH", "PB_TW")
    B, C, H, W = x.shape
    Ho, Wo = H // 2, W // 2
    dx = torch.full_like(x, float("nan"))
    for oh0 in range(0, Ho, TH):
        for ow0 in range(0, Wo, TW):
            xs = torch.full((B, C, 2 * TH + 3, 2 * TW + 3), float("-inf"))
            h0, w0 = 2 * oh0 - 1, 2 * ow0 - 1
            h1, w1 = min(h0 + 2 * TH + 3, H), min(w0 + 2 * TW + 3, W)
            xs[..., max(h0, 0) - h0:h1 - h0, max(w0, 0) - w0:w1 - w0] = \
                x[..., max(h0, 0):h1, max(w0, 0):w1]
            ys = torch.full((B, C, TH + 1, TW + 1), float("nan"))
            gs = torch.zeros((B, C, TH + 1, TW + 1))
            nr, nc = min(TH + 1, Ho - oh0), min(TW + 1, Wo - ow0)
            ys[..., :nr, :nc] = y[..., oh0:oh0 + nr, ow0:ow0 + nc]
            gs[..., :nr, :nc] = g[..., oh0:oh0 + nr, ow0:ow0 + nc]
            n = torch.zeros_like(gs)
            for dy in range(3):
                for dc in range(3):
                    n += xs[..., dy:dy + 2 * TH + 1:2,
                            dc:dc + 2 * TW + 1:2] == ys
            gc = gs / n.clamp(min=1.0)

            def win(a, b):  # the (TH, TW) windows (oh + a, ow + b)
                return ys[..., a:a + TH, b:b + TW], gc[..., a:a + TH, b:b + TW]

            quad = {}
            for a in (0, 1):
                for b in (0, 1):
                    xv = xs[..., 1 + a:1 + a + 2 * TH:2, 1 + b:1 + b + 2 * TW:2]
                    acc = torch.zeros_like(xv)
                    for wa in ((1, 0) if a else (0,)):
                        for wb in ((1, 0) if b else (0,)):
                            yv, gv = win(wa, wb)
                            acc = torch.where(xv == yv, acc + gv, acc)
                    quad[a, b] = acc
            nr, nc = min(TH, Ho - oh0), min(TW, Wo - ow0)
            for (a, b), acc in quad.items():
                dx[..., 2 * oh0 + a:2 * (oh0 + nr):2,
                   2 * ow0 + b:2 * (ow0 + nc):2] = acc[..., :nr, :nc]
    return dx


@pytest.mark.parametrize("hw", [(22, 74), (4, 6)])
def test_pool_backward_tile_schedule_is_bit_equal_to_plain(hw):
    """Ties everywhere (a ReLU of small integers), a NaN, an all -inf
    corner window (its pad taps tie too), on a shape whose windows end
    inside a tile in both H and W (tile and image edges), and on one
    smaller than a tile."""
    r = np.random.RandomState(5)
    x = np.maximum(r.randint(-1, 3, (2, 3) + hw), 0).astype(np.float32)
    x[0, 1, 5 % hw[0], 7 % hw[1]] = np.nan
    x[1, 2, :2, :2] = -np.inf
    x = torch.from_numpy(x)
    y = pool.maxpool3x3s2_plain(x)
    g = torch.from_numpy(r.standard_normal(y.shape).astype(np.float32))
    got, want = _pool_bwd_tiled(x, y, g), pool.maxpool3x3s2_bwd_plain(x, y, g)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def _reflect_np(i, n):
    i = np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))
    return np.clip(i, 0, n - 1)


def _tap_weight_np(q, d, n):
    """reproj.cu::tap_weight: the weight of input q in output q + d."""
    o = q + d
    w = 1.0 + ((d == -1) & (q == 1)) + ((d == 1) & (q == n - 2))
    return np.where((o >= 0) & (o < n), w, 0.0)


def _reproj_bwd_streamed(warped, target, g):
    """reproj_bwd_kernel's schedule in the input's dtype: per band of
    SPAN - 4 output columns (a warp's SPAN columns with a 2-column halo,
    each reflected once) and strip of TH rows, the target's moments
    staged on the strip's rows, then each warp's rows streamed through
    3-row windows of p, p^2, p t and of the box adjoint's row sums, one
    output row behind the moments."""
    CPL, TH = _cu_constants("reproj.cu", "BWD_CPL", "BWD_TH")
    SPAN = 32 * CPL
    n, k, B, C, H, W = warped.shape
    # the plain version's constants; 1/3 is float32's, as in the kernel
    C1, C2, third = 0.01 ** 2, 0.03 ** 2, float(np.float32(1.0 / 3.0))

    def tap3(a, b, c):
        return (a + b + c) * third

    def hbox(v):
        out = torch.zeros_like(v)
        out[..., 1:-1] = tap3(v[..., :-2], v[..., 1:-1], v[..., 2:])
        return out

    out = torch.full_like(warped, float("nan"))
    gc = g[:, :, :, None] / C
    cols = np.arange(SPAN)
    for y0 in range(0, H, TH):
        for x0 in range(0, W, SPAN - 4):
            xs = x0 - 2 + cols
            xr = _reflect_np(xs, W)
            mval = torch.from_numpy((cols >= 1) & (cols <= SPAN - 2)
                                    & (xs >= 0) & (xs < W))
            oval = (cols >= 2) & (cols <= SPAN - 3) & (xs < W)
            wx = [torch.from_numpy(_tap_weight_np(xs, d, W)).to(warped)
                  for d in (-1, 0, 1)]

            def hadj(v):
                out = torch.zeros_like(v)
                out[..., 1:-1] = (wx[0][1:-1] * v[..., :-2]
                                  + wx[1][1:-1] * v[..., 1:-1]
                                  + wx[2][1:-1] * v[..., 2:])
                return out

            def row(a, i):  # image row y0 - 2 + i at the band's columns
                return a[..., int(_reflect_np(y0 - 2 + i, H)), :][..., xr]

            T = [row(target, i) for i in range(TH + 4)]
            MY = [hbox(tap3(T[i], T[i + 1], T[i + 2])) for i in range(TH + 2)]
            Y2 = [hbox(tap3(T[i] ** 2, T[i + 1] ** 2, T[i + 2] ** 2))
                  for i in range(TH + 2)]
            pa, pb = row(warped, 0), row(warped, 1)
            zero = torch.zeros_like(pa)
            ha, hb, Gb = [zero] * 3, [zero] * 3, zero
            for s in range(min(TH + 2, H - y0 + 2)):
                pc = row(warped, s + 2)
                mx = hbox(tap3(pa, pb, pc))
                x2 = hbox(tap3(pa * pa, pb * pb, pc * pc))
                xy = hbox(tap3(pa * T[s], pb * T[s + 1], pc * T[s + 2]))
                my, y2 = MY[s], Y2[s]
                o = y0 + s - 1
                ok = mval & (0 <= o < H)
                Gc = torch.where(ok, gc[..., min(max(o, 0), H - 1), xr], 0.0)
                A1, A2 = 2 * mx * my + C1, 2 * (xy - mx * my) + C2
                B1, B2 = mx * mx + my * my + C1, (x2 - mx * mx) + \
                    (y2 - my * my) + C2
                q = A1 * A2 / (B1 * B2)
                raw = (1 - q) / 2
                # jnp.clip's derivative: 1 inside, 1/2 on a bound
                clip_d = torch.where((raw > 0) & (raw < 1), 1.0, torch.where(
                    (raw == 0) | (raw == 1), 0.5, 0.0))
                a = -0.5 * 0.85 * Gc * clip_d
                gn = a / (B1 * B2)
                gd = -gn * q
                coef = [2 * my * (gn * A2 - gn * A1) + 2 * mx * (gd * B2 - gd * B1),
                        gd * B1, 2 * gn * A1]
                hc = [hadj(torch.where(ok, c, 0.0)) for c in coef]
                if s >= 2:
                    qr = o - 1
                    w0, w1, w2 = (float(_tap_weight_np(qr, d, H))
                                  for d in (-1, 0, 1))
                    smu, sx2, sxy = (w0 * ha[f] + w1 * hb[f] + w2 * hc[f]
                                     for f in range(3))
                    val = (third * third * (smu + 2 * pa * sx2 + T[s] * sxy)
                           + 0.15 * Gb * torch.where(pa > T[s], 1.0, -1.0))
                    out[..., qr, xs[oval]] = val[..., oval]
                pa, pb, ha, hb, Gb = pb, pc, hb, hc, Gc
    return out


@pytest.mark.parametrize("shape", [(1, 2, 1, 3, 2, 9), (1, 1, 2, 3, 20, 2),
                                   (2, 1, 1, 3, 19, 33),
                                   (1, 2, 1, 3, 37, 70)],
                         ids=["H2", "W2", "H19", "ragged"])
def test_reproj_backward_streamed_schedule_matches_plain_f64(shape):
    """H = 2, W = 2, H = 19 and a shape whose H and W are no multiples of
    the kernel's strip and band (two of each, the last ragged), with one
    warp equal to the target (the clip at its bound)."""
    r = np.random.RandomState(6)
    n, k, B, C, H, W = shape
    warped = torch.from_numpy(r.rand(*shape))
    target = torch.from_numpy(r.rand(B, C, H, W))
    warped[-1, -1, -1] = target[-1]
    g = torch.from_numpy(r.standard_normal((n, k, B, H, W)))
    got = _reproj_bwd_streamed(warped, target, g)
    want = reproj.reproj_bwd_plain(warped, target, g)
    assert not got.isnan().any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12,
                               rtol=0)


def _reproj_fwd_streamed(warped, target):
    """reproj_fwd_kernel's schedule in the input's dtype: per band of
    SPAN - 2 output columns (a warp's SPAN columns with a 1-column halo,
    each reflected once) and strip of TH rows, the target's moments staged
    on the strip's rows; the strip cut into slices where b has fewer than
    FWD_WARPS warps, each slice's rows streamed through 3-row windows of
    p, p^2 and p t of every channel; the SSIM term as (d - n) / 2d, the
    channel sums in order, times 1 / C."""
    WARPS, CPL, TH = _cu_constants("reproj.cu", "FWD_WARPS", "FWD_CPL",
                                   "FWD_TH")
    SPAN = 32 * CPL
    n, k, B, C, H, W = warped.shape
    NK = n * k
    w = warped.reshape(NK, B, C, H, W)
    # the plain version's constants; 1/3 is float32's, as in the kernel
    C1, C2, third = 0.01 ** 2, 0.03 ** 2, float(np.float32(1.0 / 3.0))
    inv_c = 1.0 / C  # rounded to the input's dtype, as the kernel's 1.f / C

    def tap3(a, b, c):
        return (a + b + c) * third

    def hbox(v):
        out = torch.zeros_like(v)
        out[..., 1:-1] = tap3(v[..., :-2], v[..., 1:-1], v[..., 2:])
        return out

    slices = 1
    while slices * 2 * NK <= WARPS:
        slices *= 2
    rows = TH // slices
    out = torch.full((NK, B, H, W), float("nan"), dtype=warped.dtype)
    cols = np.arange(SPAN)
    for y0 in range(0, H, TH):
        for x0 in range(0, W, SPAN - 2):
            xs = x0 - 1 + cols
            xr = _reflect_np(xs, W)
            oval = (cols >= 1) & (cols <= SPAN - 2) & (xs < W)

            def row(a, i):  # image row i at the band's columns
                return a[..., int(_reflect_np(i, H)), :][..., xr]

            T = {i: row(target, i) for i in range(y0 - 1, y0 + TH + 1)}
            MY = {o: hbox(tap3(T[o - 1], T[o], T[o + 1]))
                  for o in range(y0, y0 + TH)}
            Y2 = {o: hbox(tap3(T[o - 1] ** 2, T[o] ** 2, T[o + 1] ** 2))
                  for o in range(y0, y0 + TH)}
            for sl in range(slices):
                ys = y0 + sl * rows
                ye = min(ys + rows, y0 + TH, H)
                P = {i: row(w, i) for i in range(ys - 1, ye + 1)}
                for r in range(ys, ye):
                    pa, pb, pc = P[r - 1], P[r], P[r + 1]
                    mx = hbox(tap3(pa, pb, pc))
                    x2 = hbox(tap3(pa * pa, pb * pb, pc * pc))
                    xy = hbox(tap3(pa * T[r - 1], pb * T[r], pc * T[r + 1]))
                    my, y2 = MY[r], Y2[r]
                    num = (2 * mx * my + C1) * (2 * (xy - mx * my) + C2)
                    den = (mx * mx + my * my + C1) * \
                        ((x2 - mx * mx) + (y2 - my * my) + C2)
                    ssim = torch.clamp((den - num) / (2 * den), 0.0, 1.0)
                    l1 = (T[r] - pb).abs()
                    s_sum = l_sum = 0.0
                    for c in range(C):
                        s_sum = s_sum + ssim[..., c, :]
                        l_sum = l_sum + l1[..., c, :]
                    val = 0.85 * (s_sum * inv_c) + 0.15 * (l_sum * inv_c)
                    out[..., r, xs[oval]] = val[..., oval]
    return out.reshape(n, k, B, H, W)


@pytest.mark.parametrize("shape", [(2, 4, 1, 3, 37, 70),
                                   (2, 1, 2, 3, 45, 130), (1, 2, 1, 3, 2, 2),
                                   (1, 1, 2, 3, 20, 2)],
                         ids=["ragged", "identity", "H2W2", "W2"])
def test_reproj_forward_streamed_schedule_matches_plain_f64(shape):
    """Strips and bands that do not divide H and W (two of each, the last
    ragged), an identity-shaped call (2 warps a batch element, so the
    strip is cut into slices; three strips, the last ragged), H = W = 2,
    and W = 2 with one warp (8 slices), one warp equal to the target."""
    r = np.random.RandomState(8)
    n, k, B, C, H, W = shape
    warped = torch.from_numpy(r.rand(*shape))
    target = torch.from_numpy(r.rand(B, C, H, W))
    warped[-1, -1, -1] = target[-1]
    got = _reproj_fwd_streamed(warped, target)
    assert not got.isnan().any()
    np.testing.assert_allclose(got.numpy(),
                               reproj.reproj_plain(warped, target).numpy(),
                               atol=1e-12, rtol=0)


def test_reproj_forward_tap3_moments_give_zero_where_warped_is_target():
    """In float32, moments rounded step by step in box3's order give
    n == d, so a loss of exactly 0, where warped == target: on a whole
    plane, and inside a patch wherever the 3x3 window lies in it; and the
    map within 1e-6 of the float32 plain version elsewhere."""
    r = np.random.RandomState(9)
    warped = torch.from_numpy(r.rand(2, 4, 2, 3, 40, 70).astype(np.float32))
    target = torch.from_numpy(r.rand(2, 3, 40, 70).astype(np.float32))
    warped[1, 3, 1] = target[1]
    warped[0, 0, 0, :, 5:20, 10:30] = target[0, :, 5:20, 10:30]
    got = _reproj_fwd_streamed(warped, target)
    assert torch.equal(got[1, 3, 1], torch.zeros(40, 70))
    assert torch.equal(got[0, 0, 0, 6:19, 11:29], torch.zeros(13, 18))
    np.testing.assert_allclose(got.numpy(),
                               reproj.reproj_plain(warped, target).numpy(),
                               atol=1e-6, rtol=0)


def test_reproj_forward_refuses_more_channels_than_it_keeps():
    C = reproj.MAX_FWD_CHANNELS + 1
    w = torch.zeros(1, 1, 1, C, 4, 8, device="meta")
    t = torch.zeros(1, C, 4, 8, device="meta")
    with pytest.raises(ValueError, match="at most"):
        reproj._check("reproj", w, t, reproj.MAX_FWD_CHANNELS)


# ---- the warp kernels' schedule, modelled (csrc/warp.cu) ----

def _odd_view(t):
    """t as a contiguous view one float past an aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def _warp_schedule(ix, iy, sources, g=None):
    """warp_fwd_kernel's schedule (warp_bwd_kernel's with g) in float64 on
    float32 inputs: a block per (tile of WARP_ROWS rows x 32 WARP_COLS
    columns, n B + b), n and b taken apart by subtraction as the kernel
    does, WARP_COLS columns 32 apart a thread, each inside iff 32 j < W - w
    (a column outside reads the thread's first column, whose taps must
    stay in the plane, and is not written), the K scales in a loop inside
    the block, the taps as flat offsets y W + x into the (n, b) plane, the
    backward summed over c in order. Each output is checked to be written
    exactly once."""
    ROWS, COLS = _cu_constants("warp.cu", "WARP_ROWS", "WARP_COLS")
    N, K, B, H, W = ix.shape
    C = sources.shape[2]
    by, ty, bx, tx, j = torch.meshgrid(
        torch.arange(-(-H // ROWS)), torch.arange(ROWS),
        torch.arange(-(-W // (32 * COLS))), torch.arange(32),
        torch.arange(COLS), indexing="ij")
    h, w = by * ROWS + ty, bx * 32 * COLS + tx  # the thread's first column
    thread = (h < H) & (w < W)
    col = (32 * j < W - w)[thread]
    pix = torch.where(col, (h * W + w + 32 * j)[thread], (h * W + w)[thread])
    assert pix[col].unique().numel() == int(col.sum()) == H * W
    HW = H * W
    cx, cy = ix.double().reshape(-1, HW), iy.double().reshape(-1, HW)
    planes = sources.double().reshape(N * B, C, HW)
    if g is None:
        out = torch.full((N * K * B, C, HW), float("nan"), dtype=torch.float64)
    else:
        gc = g.double().reshape(N * K * B, C, HW)
        out = torch.full((2, N * K * B, HW), float("nan"), dtype=torch.float64)
    for z in range(N * B):
        n, b = 0, z
        while b >= B:
            b, n = b - B, n + 1
        s = planes[z]
        for k in range(K):
            nkb = (n * K + k) * B + b
            x, y = cx[nkb, pix], cy[nkb, pix]
            x0f, y0f = torch.floor(x), torch.floor(y)
            x0, y0 = x0f.long(), y0f.long()
            x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
            wx, wy = x - x0f, y - y0f
            taps = [yi * W + xi for yi, xi in
                    ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
            assert all(((t >= 0) & (t < HW)).all() for t in taps)
            v00, v01, v10, v11 = (s[:, t] for t in taps)
            at = pix[col]
            if g is None:
                assert out[nkb][:, at].isnan().all()
                r = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
                     + v10 * (1 - wx) * wy + v11 * wx * wy)
                out[nkb][:, at] = r[:, col]
                continue
            ax = torch.zeros_like(x)
            ay = torch.zeros_like(x)
            for c in range(C):
                ax = ax + gc[nkb, c, pix] * ((v01[c] - v00[c]) * (1 - wy)
                                             + (v11[c] - v10[c]) * wy)
                ay = ay + gc[nkb, c, pix] * ((v10[c] - v00[c]) * (1 - wx)
                                             + (v11[c] - v01[c]) * wx)
            assert out[:, nkb, at].isnan().all()
            out[0, nkb, at], out[1, nkb, at] = ax[col], ay[col]
    if g is None:
        return out.reshape(N, K, B, C, H, W)
    return out[0].reshape(ix.shape), out[1].reshape(ix.shape)


def _warp_edge_case(H, W, odd, seed=11):
    """float32 coordinates for 3 sources, 4 scales, batch 2, 3 channels:
    near the identity, far displacements (300 and 100 px) on one scale,
    every coordinate of one (n, k, b) on the last column and row, and the
    first columns and rows at 0; with `odd`, every input a view one float
    past an aligned start."""
    r = np.random.RandomState(seed)
    n, k, B, C = 3, 4, 2, 3
    jj, ii = np.arange(W)[None], np.arange(H)[:, None]
    ix = jj + r.standard_normal((n, k, B, H, W)) * 3
    iy = ii + r.standard_normal((n, k, B, H, W)) * 3
    ix[:, 1] = jj + 300 * r.standard_normal((n, B, H, W))
    iy[:, 1] = ii + 100 * r.standard_normal((n, B, H, W))
    ix[2, 3, 1], iy[2, 3, 1] = W - 1, H - 1
    ix[0, 0, 0, :, :2], iy[0, 0, 0, :2] = 0, 0
    t = [torch.from_numpy(a.astype(np.float32)) for a in (
        np.clip(ix, 0, W - 1), np.clip(iy, 0, H - 1),
        r.rand(n, B, C, H, W), r.standard_normal((n, k, B, C, H, W)))]
    return [_odd_view(a) for a in t] if odd else t


@pytest.mark.parametrize("H, W, odd", [
    (H, W, False) for W in (1, 3, 5, 32, 33, 53, 64, 65, 130)
    for H in (1, 37)] + [(37, 130, True)])
def test_warp_schedule_matches_plain_f64(H, W, odd):
    """The kernels' schedule on rows shorter than a warp (W < 32), a second
    column partly (33, 53) or wholly (W <= 32) outside the row, whole and
    ragged column tiles (64, 65, 130) and row tiles (H = 37), and on views
    one float past an aligned start: forward and backward within 1e-12 of
    the plain versions in float64, every output written once."""
    ix, iy, src, g = _warp_edge_case(H, W, odd)
    d = [t.double() for t in (ix, iy, src, g)]
    torch.testing.assert_close(_warp_schedule(ix, iy, src),
                               warp.warp_plain(*d[:3]), atol=1e-12, rtol=0)
    gix, giy = _warp_schedule(ix, iy, src, g)
    want = warp.warp_bwd_plain(*d)
    torch.testing.assert_close(gix, want[0], atol=1e-12, rtol=0)
    torch.testing.assert_close(giy, want[1], atol=1e-12, rtol=0)


def test_profile_files_every_port_kernel_under_port_kernels():
    """scripts/torch_train_profile.py reads the __global__ kernels out of
    kernels/csrc (those behind __launch_bounds__ too) and files each, named
    as the profiler names it, under "port kernels" (a hand conv's name
    holds "conv", which would file it under cuDNN)."""
    spec = importlib.util.spec_from_file_location(
        "torch_train_profile",
        Path(__file__).resolve().parents[1] / "scripts" /
        "torch_train_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    names = prof.port_kernel_names()
    assert {"conv3x3_fwd_kernel", "conv3x3_wgrad_kernel", "warp_fwd_kernel",
            "warp_bwd_kernel", "reproj_fwd_kernel", "reproj_bwd_kernel",
            "knn_partial_kernel", "maxpool3x3s2_bwd_kernel"} <= names
    for name in sorted(names):
        for shown in (f"(anonymous namespace)::{name}(float const*, int)",
                      f"void (anonymous namespace)::{name}<2>(float const*)"):
            assert prof.group(shown) == "port kernels", shown
    assert prof.group("sm80_xmma_fprop_implicit_gemm_f32") == \
        "cuDNN convolutions"
