"""The port's tensor ops (fusiondepth_torch/ops) against the JAX package's,
on the same numpy-made inputs. The port is NCHW and the JAX package NHWC,
so inputs and outputs are moved across. These ops copy or select values,
or are one elementwise formula, so they agree exactly (padding, resize)
or to float32 rounding (depth)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusiondepth_tpu.ops.depth import disp_to_depth as jax_disp_to_depth
from fusiondepth_tpu.ops.padding import reflect_pad_hw as jax_reflect_pad
from fusiondepth_tpu.ops.resize import upsample2x_nearest as jax_upsample
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.padding import reflect_pad_hw
from fusiondepth_torch.ops.resize import upsample2x_nearest


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("pad", [0, 1, 2])
def test_reflect_pad_matches_jax(pad):
    x = _x((2, 5, 7, 3))
    np.testing.assert_array_equal(_nhwc(reflect_pad_hw(_nchw(x), pad)),
                                  np.asarray(jax_reflect_pad(jnp.asarray(x),
                                                             pad)))


def test_upsample2x_nearest_matches_jax():
    x = _x((2, 3, 5, 4))
    np.testing.assert_array_equal(_nhwc(upsample2x_nearest(_nchw(x))),
                                  np.asarray(jax_upsample(jnp.asarray(x))))


def test_disp_to_depth_matches_jax():
    disp = np.random.default_rng(1).uniform(0, 1, (2, 1, 6, 8)).astype(
        np.float32)
    got = disp_to_depth(torch.from_numpy(disp), 0.1, 100.0)
    want = jax_disp_to_depth(jnp.asarray(disp), 0.1, 100.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
