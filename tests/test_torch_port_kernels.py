"""The port's kernel modules (fusiondepth_torch/kernels) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy-made
inputs. On the CPU each wrapper takes its plain PyTorch version, so this
holds the plain versions (the reference the CUDA kernels are checked
against on the card by chip_smoke.py) to the TPU kernels' semantics.

Tolerances: the pool is a max, so exact; the convs sum at most 9 * 16
float32 products in another order than the Pallas dots: atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusiondepth_tpu.ops.folded import fold, unfold
from fusiondepth_tpu.ops.pallas_fold_conv import (
    fold_conv3x3_pallas,
    fold_conv3x3_zero_pallas,
)
from fusiondepth_tpu.ops.pallas_pool import max_pool_3x3s2_pallas
from fusiondepth_tpu.ops.pooling import max_pool_3x3s2 as jax_pool
from fusiondepth_torch.kernels import LAUNCHES, build, conv3x3, pool
from fusiondepth_torch.ops.pooling import max_pool_3x3s2


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
    before = dict(LAUNCHES)
    x = torch.zeros(1, 4, 8, 8)
    pool.maxpool3x3s2(x)
    conv3x3.conv3x3_reflect(x, torch.zeros(2, 4, 3, 3), torch.zeros(2))
    conv3x3.conv3x3_zero_act(x, torch.zeros(2, 4, 3, 3))
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
    with pytest.raises(ValueError, match="expected cuda"):
        conv3x3.conv3x3_reflect(x, torch.zeros(2, 4, 3, 3, device="meta"),
                                torch.zeros(2, device="meta"))
