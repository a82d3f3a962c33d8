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

from test_torch_port_models import few_torch_threads  # noqa: F401


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


# ---- the training path's ops, in float64 against the JAX package's ----
# Both sides differ only by summation order: 1e-9 or tighter, except where
# the JAX side rounds to float32 (box3, see below).

import jax  # noqa: E402

from fusiondepth_tpu.ops import geometry as jax_geometry  # noqa: E402
from fusiondepth_tpu.ops import losses as jax_losses  # noqa: E402
from fusiondepth_tpu.ops import planes as jax_planes  # noqa: E402
from fusiondepth_tpu.ops import pose as jax_pose  # noqa: E402
from fusiondepth_tpu.ops.depth import depth_to_disp as jax_depth_to_disp  # noqa: E402,E501
from fusiondepth_tpu.ops.resize import resize_bilinear as jax_resize  # noqa: E402,E501
from fusiondepth_torch.ops import geometry, losses, planes, pose  # noqa: E402
from fusiondepth_torch.ops.depth import depth_to_disp  # noqa: E402
from fusiondepth_torch.ops.resize import (  # noqa: E402
    resize_antialias,
    resize_bilinear,
)

F64 = dict(atol=1e-9, rtol=0)


def _rng(seed):
    return np.random.default_rng(seed)


def _t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def test_depth_to_disp_matches_jax_f64():
    depth = _rng(2).uniform(0.1, 100.0, (2, 6, 8, 1))
    with jax.enable_x64():
        want = np.asarray(jax_depth_to_disp(jnp.asarray(depth), 0.1, 100.0))
    np.testing.assert_allclose(depth_to_disp(_t64(depth), 0.1, 100.0).numpy(),
                               want, **F64)


@pytest.mark.parametrize("invert", [False, True])
def test_pose_matches_jax_f64(invert):
    r = _rng(3)
    aa, t = r.normal(0, 0.3, (4, 3)), r.normal(0, 1.0, (4, 3))
    aa[0] = 0.0  # the zero rotation goes through the 1e-7 eps
    with jax.enable_x64():
        want = np.asarray(jax_pose.transformation_from_parameters(
            jnp.asarray(aa), jnp.asarray(t), invert=invert))
        want_rot = np.asarray(jax_pose.rot_from_axisangle(jnp.asarray(aa)))
    np.testing.assert_allclose(pose.rot_from_axisangle(_t64(aa)).numpy(),
                               want_rot, **F64)
    np.testing.assert_allclose(pose.transformation_from_parameters(
        _t64(aa), _t64(t), invert=invert).numpy(), want, **F64)


def test_geometry_matches_jax_f64():
    r = _rng(4)
    B, H, W = 2, 6, 10
    depth = r.uniform(1.0, 50.0, (B, H, W, 1))
    K = np.tile(np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1.0]]), (B, 1, 1))
    T = np.tile(np.eye(4), (B, 1, 1))
    T[:, :3, 3] = r.normal(0, 0.2, (B, 3))
    with jax.enable_x64():
        pts = jax_geometry.backproject_depth(jnp.asarray(depth),
                                             jnp.asarray(np.linalg.inv(K)))
        pix = np.asarray(jax_geometry.project_3d(pts, jnp.asarray(K),
                                                 jnp.asarray(T)))
        grid = np.asarray(jax_geometry.pixel_grid(H, W, jnp.float64))
    np.testing.assert_array_equal(
        geometry.pixel_grid(H, W, torch.float64).numpy(), grid)
    got_pts = geometry.backproject_depth(_t64(depth[..., 0]),
                                         _t64(np.linalg.inv(K)))
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(pts), **F64)
    np.testing.assert_allclose(geometry.project_3d(
        got_pts, _t64(K), _t64(T)).numpy(), pix, atol=1e-9, rtol=1e-12)


@pytest.mark.parametrize("size", [(64, 96), (7, 11)])
def test_resize_bilinear_matches_jax_f64(size):
    x = _rng(5).standard_normal((2, 8, 12, 3))
    with jax.enable_x64():
        want = np.asarray(jax_resize(jnp.asarray(x), *size))
    got = resize_bilinear(_nchw(x).double(), *size)
    np.testing.assert_allclose(_nhwc(got), want, **F64)


@pytest.mark.parametrize("hw", [(64, 96), (48, 80)])
def test_antialias_pyramid_matches_jax_image_resize_f64(hw):
    """The smoothness pyramid: jax.image.resize(antialias=True) at each
    scale, on planes as photometric._pyramid_planes calls it."""
    H, W = hw
    x = _rng(6).uniform(0, 1, (2, 3, H, W))
    with jax.enable_x64():
        want = {s: np.asarray(jax.image.resize(
            jnp.asarray(x), (2, 3, H >> s, W >> s), method="bilinear",
            antialias=True)) for s in (1, 2, 3)}
    for s, w in want.items():
        np.testing.assert_allclose(
            resize_antialias(_t64(x), H >> s, W >> s).numpy(), w, **F64,
            err_msg=f"scale {s}")


def _box3_f64(x):
    """The JAX box3 with its banded products kept in float64: the JAX box3
    rounds each product to float32 even under x64
    (preferred_element_type=float32)."""
    V = jnp.asarray(jax_planes._box3_matrix(x.shape[-2]), x.dtype)
    Hm = jnp.asarray(jax_planes._box3_matrix(x.shape[-1]), x.dtype)
    y = jnp.einsum("ih,...hw->...iw", V, x, precision="highest")
    return jnp.einsum("jw,...hw->...hj", Hm, y, precision="highest")


def test_planes_ops_match_jax_f64(monkeypatch):
    """box3 against the JAX box3 to its float32 rounding (1e-7); the rest
    to 1e-12 against the JAX functions with box3's products in float64."""
    r = _rng(8)
    n, k, B, C, H, W = 2, 3, 2, 3, 10, 14
    pred = r.uniform(0, 1, (n, k, B, C, H, W))
    target = r.uniform(0, 1, (B, C, H, W))
    disp = r.uniform(0.01, 1.0, (B, H, W))
    with jax.enable_x64():
        jp, jt = jnp.asarray(pred), jnp.asarray(target)
        box3_f32 = np.asarray(jax_planes.box3(jp))
        monkeypatch.setattr(jax_planes, "box3", _box3_f64)
        want = {
            "box3": jax_planes.box3(jp),
            "ssim": jax_planes.ssim_planes(jp, jt[None, None]),
            "reproj": jax_planes.reprojection_loss_planes(jp, jt[None, None]),
            "l1": jax_planes.reprojection_loss_planes(jp, jt[None, None],
                                                      use_ssim=False),
            "resize": jax_planes.resize_planes(jnp.asarray(disp), 24, 32),
            "smooth": jax_planes.smoothness_planes(jnp.asarray(disp), jt),
            "nsmooth": jax_planes.normalized_smoothness_planes(
                jnp.asarray(disp), jt),
        }
        want = {key: np.asarray(v) for key, v in want.items()}
    tp, tt, td = _t64(pred), _t64(target), _t64(disp)
    got = {
        "box3": planes.box3(tp),
        "ssim": planes.ssim_planes(tp, tt[None, None]),
        "reproj": planes.reprojection_loss_planes(tp, tt[None, None]),
        "l1": planes.reprojection_loss_planes(tp, tt[None, None],
                                              use_ssim=False),
        "resize": planes.resize_planes(td, 24, 32),
        "smooth": planes.smoothness_planes(td, tt),
        "nsmooth": planes.normalized_smoothness_planes(td, tt),
    }
    np.testing.assert_allclose(got["box3"].numpy(), box3_f32, atol=1e-7)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-12,
                                   rtol=0, err_msg=key)
    nhwc = r.standard_normal((B, H, W, C))
    np.testing.assert_array_equal(
        planes.from_planes(planes.to_planes(_t64(nhwc))).numpy(), nhwc)
    with jax.enable_x64():
        want_p = np.asarray(jax_planes.to_planes(jnp.asarray(nhwc)))
    np.testing.assert_array_equal(planes.to_planes(_t64(nhwc)).numpy(),
                                  want_p)


def test_si_loss_and_masked_mean_match_jax_f64():
    r = _rng(9)
    depth = r.uniform(0.5, 90.0, (2, 16, 24))
    ref = np.where(r.uniform(size=depth.shape) < 0.3,
                   depth + r.normal(0, 1.0, depth.shape), 0.0)
    mask = r.uniform(size=depth.shape) < 0.4
    with jax.enable_x64():
        want = float(jax_losses.si_loss(jnp.asarray(depth), jnp.asarray(ref),
                                        threshold=2.0, si_var=0.3))
        want_none = float(jax_losses.si_loss(jnp.asarray(depth),
                                             jnp.zeros_like(depth)))
        want_mm = float(jax_losses.masked_mean(jnp.asarray(depth),
                                               jnp.asarray(mask)))
    assert want > 0
    got = losses.si_loss(_t64(depth), _t64(ref), threshold=2.0, si_var=0.3)
    assert abs(float(got) - want) < 1e-12
    assert float(losses.si_loss(_t64(depth), torch.zeros(depth.shape,
                                dtype=torch.float64))) == want_none == 0.0
    # the JAX masked_mean accumulates in float32 whatever its input; the
    # port's keeps the input's dtype: equal in float32
    got_mm = losses.masked_mean(_t64(depth).float(), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got_mm), want_mm, rtol=1e-6)
