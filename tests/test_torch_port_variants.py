"""The stage-1 training variants of the port (fusiondepth_torch), the rest
of evaluation and the host data-prep CLIs, against the JAX package on the
CPU.

Whole steps, float64, B=2, 64x96, R18, the weights carried across by
models/jax_weights and the automask noise replayed through `noise=`
(the setup of tests/test_torch_port_train.py, at its bounds: the loss to
1e-7 absolute, every gradient leaf to rtol 1e-5 / atol 1e-9, the
forward's disparities, masks and poses and the BN statistics to 1e-9,
the parameters after one Adam step to 1e-6), in two configurations with
frame_ids (0, -1, 1, "s"):
- A: v1_multiscale + use_stereo + the posecnn pose net, automask on,
  without the beam encoders (the reference formulation: warps and SSIM
  at each scale's resolution, the posecnn translation rescaled by the
  mean inverse depth, the stereo frame warped by stereo_T);
- B: the shared pose type + use_stereo + predictive_mask with
  disable_automasking (the planes formulation: the depth encoder over
  B x 4 frames in one pass, the mask decoder's 3 channels, its BCE).
The JAX side of each is one jitted function, computed once per module
in a thread from its first test on (test_torch_port_models.JaxSides;
the whole-step tests come last), on the JAX package's generic path (its
TPU layout flags off, test_torch_port_models.GENERIC), with the JAX
planes box3's products kept in float64
(test_torch_port_ops._box3_f64): the JAX box3 rounds them to float32 even
under x64, which moves B's mask-weighted decoder gradients by up to 7e-9,
beyond the 1e-9 absolute bound.

Cheaper pieces, each against its JAX counterpart: PoseCNN over pairs and
over all frames; the separate_resnet poses with pose_model_input="all";
`ops/sampling.py::grid_sample` and the per-scale reprojection maps;
v1_multiscale's loss and its gradients with respect to the disparities,
the poses and the mask, from a given outputs dict; the visualize,
per_semantic and benchmark branches of evaluate; the four host CLIs
against the root scripts.
"""

import concurrent.futures
import functools
import os
import runpy
import shutil
import sys

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.data.fixtures import build_synthetic_kitti_tree
from fusiondepth_tpu.data.kitti_io import generate_depth_map
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.models.pose import PoseCNN as JaxPoseCNN
from fusiondepth_tpu.ops.losses import reprojection_loss as \
    jax_reprojection_loss
from fusiondepth_tpu.ops import planes as jax_planes
from fusiondepth_tpu.ops.sampling import grid_sample as jax_grid_sample
from fusiondepth_tpu.training import eval_driver as jax_eval
from fusiondepth_tpu.training import photometric as jax_photometric
from fusiondepth_tpu.training.train_state import (
    make_loss_fn,
    make_optimizer as jax_make_optimizer,
    split_variables,
)
from fusiondepth_torch import export_gt_depth as port_export_gt_depth
from fusiondepth_torch import gen2channel as port_gen2channel
from fusiondepth_torch import gen2channel_detec as port_gen2channel_detec
from fusiondepth_torch import sparsify as port_sparsify
from fusiondepth_torch.config import Config
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import (
    NETS,
    from_jax_variables,
    to_jax_variables,
)
from fusiondepth_torch.models.pose import PoseCNN
from fusiondepth_torch.ops.losses import reprojection_loss
from fusiondepth_torch.ops.planes import to_planes
from fusiondepth_torch.ops.sampling import grid_sample
from fusiondepth_torch.training import eval_driver
from fusiondepth_torch.training import photometric
from fusiondepth_torch.training.infer_driver import device_batch
from fusiondepth_torch.training.train_state import make_optimizer, \
    train_step
from fusiondepth_torch.training.trainer import TRAIN_KEYS

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jax_sides_in_threads, jit, \
    load_into, random_variables
from test_torch_port_ops import _box3_f64
from test_torch_port_train import assert_trees_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 96
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch")
STEREO = dict(use_stereo=True, frame_ids=(0, -1, 1, "s"))
CONFIGS = {
    # A's beam encoders are the default step's (test_torch_port_train.py);
    # without them its JAX side compiles faster
    "A": dict(STEREO, v1_multiscale=True, pose_model_type="posecnn",
              beam_encoder=False),
    "B": dict(STEREO, pose_model_type="shared", predictive_mask=True,
              disable_automasking=True),
}
STEPS_PER_EPOCH = 10
CPU = torch.device("cpu")
SRC = (-1, 1)
POSE_KEYS = [(k, 0, f) for f in SRC
             for k in ("axisangle", "translation", "cam_T_cam")]


def stereo_inputs(frames=4, seed=11):
    """A batch of `frames` frames (frame_ids (0, -1, 1, "s")) in the
    recipe of tests/test_torch_port_train.py, with a stereo_T of the
    dataset's form (a 0.1 m baseline, its sign per sample)."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 1, (B, frames, H, W, 3))
    color_aug = np.clip(color + rng.normal(0, 0.02, color.shape), 0, 1)
    two_ch = np.zeros((B, frames, H, W, 2))
    hit = rng.uniform(size=(B, frames, H, W)) < 0.15
    d = rng.uniform(2.0, 20.0, (B, frames, H, W))
    two_ch[..., 0] = np.where(hit, d / 100.0, 0.0)
    two_ch[..., 1] = np.where(hit, 1.0 / (d + 1.0), 0.0)
    four_beam = np.where(rng.uniform(size=(B, H, W, 1)) < 0.1,
                         rng.uniform(3.0, 7.0, (B, H, W, 1)) / 100.0, 0.0)
    K = np.zeros((B, 4, 4))
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    stereo_T = np.tile(np.eye(4), (B, 1, 1))
    stereo_T[:, 0, 3] = [0.1, -0.1]
    return {"color": color, "color_aug": color_aug, "two_channel": two_ch,
            "four_beam": four_beam, "K": K, "inv_K": np.linalg.inv(K),
            "stereo_T": stereo_T}


def forward_keys(cfg):
    """(name, getter) of the outputs held at 1e-9: the forward's, and with
    the automask the loss's selection maps (exact 0/1), which the loss
    adds to the forward's outputs dict on both sides."""
    keys = [(f"disp {s}", lambda o, s=s: o[("disp", s)])
            for s in cfg.scales]
    keys += [(str(k), lambda o, k=k: o[k]) for k in POSE_KEYS]
    if cfg.predictive_mask:
        keys += [(f"mask {s}", lambda o, s=s: o["predictive_mask"][
            ("disp", s)]) for s in cfg.scales]
    if not cfg.disable_automasking:
        keys += [(f"identity_selection/{s}",
                  lambda o, s=s: o[f"identity_selection/{s}"])
                 for s in cfg.scales]
    return keys


def jax_noise(cfg, key):
    """The automask tie-break noise the JAX loss draws at each scale
    under v1_multiscale, (B, H_s, W_s, n), in the port's layout
    (candidates first)."""
    noise, r = [], key
    for s in cfg.scales:
        r, sub = jax.random.split(r)
        noise.append(torch.from_numpy(np.moveaxis(np.asarray(
            jax.random.normal(sub, (B, H >> s, W >> s,
                                    len(cfg.frame_ids) - 1))), -1, 0)
            * 1e-5))
    return noise


def jax_variant_step(name):
    """make_loss_fn's loss, gradients, BN statistics and training-mode
    forward, and make_train_step's Adam update, for one configuration."""
    kw = {**KW, **CONFIGS[name]}
    batch = stereo_inputs()
    with jax.enable_x64():
        cfg = JaxConfig(**kw, pallas_warp=False, **GENERIC)
        nets = JaxFusionNets(cfg)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0),
                                               batch_size=B),
                             np.random.default_rng(0), np.float64)
        params, stats = split_variables(v)
        key = jax.random.PRNGKey(42)
        loss_f = make_loss_fn(cfg, nets)
        tx = jax_make_optimizer(cfg, STEPS_PER_EPOCH)
        getters = [g for _, g in forward_keys(cfg)]
        forward, seen = nets.forward, {}

        def recording_forward(*args, **kwargs):
            seen["out"], updates = forward(*args, **kwargs)
            return seen["out"], updates

        def run(params, stats, batch, key):
            def loss_and_forward(params):
                nets.forward = recording_forward
                try:
                    loss, aux = loss_f(params, stats, batch, key)
                finally:
                    del nets.forward
                out = seen.pop("out")
                return loss, (aux, [g(out) for g in getters])

            (loss, ((losses, new_stats), fwd)), grads = jax.value_and_grad(
                loss_and_forward, has_aux=True)(params)
            updates, _ = tx.update(grads, tx.init(params), params)
            return fwd, loss, grads, new_stats, optax.apply_updates(
                params, updates)

        out = jit(run)(params, stats,
                       {k: jnp.asarray(x) for k, x in batch.items()}, key)
        fwd, loss, grads, new_stats, new_params = jax.tree.map(np.asarray,
                                                               out)
        noise = None if cfg.disable_automasking else jax_noise(cfg, key)
    return dict(name=name, kw=kw,
                variables={k: v[k] for k in NETS if k in v}, batch=batch,
                fwd=fwd, loss=float(loss), grads=grads, new_stats=new_stats,
                new_params=new_params, noise=noise)


@functools.cache
def jax_variant_steps():
    """`jax_variant_step` of every configuration, traced, compiled and run
    in a thread each at once (XLA's compile releases the GIL), with the
    planes box3's products kept in float64 in both."""
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as pool:
        mp.setattr(jax_planes, "box3", _box3_f64)
        return dict(zip(CONFIGS, pool.map(jax_variant_step, CONFIGS)))


@pytest.fixture(scope="module", autouse=True)
def jax_variant_sides():
    """`jax_variant_steps` under way in a thread from the module's first
    test on (test_torch_port_models.JaxSides; under pytest-xdist from the
    first test that reads it), while the tests before the steps' run."""
    with jax_sides_in_threads(steps=lambda sides: jax_variant_steps()) \
            as sides:
        yield sides


# ---- the pose nets ----

@pytest.mark.parametrize("frames", [2, 3])
def test_posecnn_matches_jax_f64(frames):
    """PoseCNN over a pair and over all 3 frames, the weights carried
    from JAX and back unchanged."""
    rng = np.random.default_rng(frames)
    x = rng.uniform(0, 1, (B, H, W, 3 * frames))
    with jax.enable_x64():
        jnet = JaxPoseCNN(num_input_frames=frames, dtype=jnp.float64)
        v = random_variables(lambda: jnet.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)),
                             rng, np.float64)
        want = jax.tree.map(np.asarray, jit(jnet.apply)(v, jnp.asarray(x)))
    net = PoseCNN(frames).double()
    load_into(net, "pose", v)
    back = to_jax_variables({f"pose.{k}": t
                             for k, t in net.state_dict().items()})["pose"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (B, frames - 1, 1, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-9, rtol=0)


def test_separate_resnet_all_poses_match_jax_f64():
    """pose_model_input="all": the pose encoder over the three stacked
    frames in training mode, one pose decoder call, no beam feature and no
    inverted transform; the poses and the pose encoder's BN statistics."""
    kw = dict(KW, pose_model_input="all")
    batch = {k: v[:, :3] if k in ("color", "color_aug", "two_channel")
             else v for k, v in stereo_inputs().items()
             if k != "stereo_T"}
    with jax.enable_x64():
        cfg = JaxConfig(**kw, pallas_warp=False, **GENERIC)
        nets = JaxFusionNets(cfg)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0),
                                               batch_size=B),
                             np.random.default_rng(3), np.float64)
        want, upd = jax.tree.map(np.asarray, jit(
            lambda v, b: nets.predict_poses(v, b, None, train=True))(
            v, {k: jnp.asarray(x) for k, x in batch.items()}))
    ours = FusionNets(Config(**kw), device=CPU)
    assert ours.pose_encoder.conv1.in_channels == 9
    ours.load_state_dict(from_jax_variables(
        {k: v[k] for k in NETS if k in v}))
    ours.train(True)
    with torch.no_grad():
        got = ours.predict_poses(device_batch(batch, CPU, TRAIN_KEYS,
                                              torch.float64))
    assert set(got) == set(want) == set(POSE_KEYS)
    for k in POSE_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-9,
                                   rtol=0, err_msg=str(k))
    stats = to_jax_variables(ours.state_dict())["pose_encoder"]
    assert_trees_close(stats["batch_stats"],
                       upd["pose_encoder"]["batch_stats"], rtol=0,
                       atol=1e-9)


# ---- the per-scale warp and reprojection maps ----

def test_grid_sample_and_reprojection_loss_match_jax():
    """`grid_sample` (one warp-kernel call over the stacked sources)
    against JAX ops/sampling.py per source, with coordinates beyond the
    border on every side, and the per-scale `reprojection_loss` against
    ops/losses.py (SSIM of ops/ssim.py), SSIM on and off, float64."""
    rng = np.random.default_rng(2)
    n, h, w = 3, H // 2, W // 2
    src = rng.uniform(0, 1, (n, B, h, w, 3))
    grids = rng.uniform(-1.3, 1.3, (n, B, h, w, 2))
    target = rng.uniform(0, 1, (B, h, w, 3))
    with jax.enable_x64():
        want = np.asarray(jit(jax.vmap(jax_grid_sample))(
            jnp.asarray(src), jnp.asarray(grids)))
        warped = np.clip(want + rng.normal(0, 0.05, want.shape), 0, 1)
        maps = np.asarray(jit(jax.vmap(lambda p, t: jnp.stack([
            jax_reprojection_loss(p, t, use_ssim=ssim)[..., 0]
            for ssim in (True, False)]), in_axes=(0, None)))(
            jnp.asarray(warped), jnp.asarray(target)))
        want_maps = {True: maps[:, 0], False: maps[:, 1]}
    got = grid_sample(torch.from_numpy(np.moveaxis(src, -1, 2).copy()),
                      torch.from_numpy(grids))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 2, -1), want,
                               atol=1e-12, rtol=0)
    for ssim in (True, False):
        maps = reprojection_loss(
            torch.from_numpy(np.moveaxis(warped, -1, 2).copy()),
            to_planes(torch.from_numpy(target)), ssim)
        np.testing.assert_allclose(maps.numpy(), want_maps[ssim],
                                   atol=1e-12, rtol=0)


# ---- v1_multiscale's loss from given outputs ----

# v1_multiscale's branches that configuration A's whole step (use_stereo,
# posecnn, SSIM, the automask) does not take
V1_KW = dict(KW, v1_multiscale=True, predictive_mask=True,
             disable_automasking=True, avg_reprojection=True, no_ssim=True)


def v1_outputs(cfg, rng):
    """A network's outputs, drawn from a seed: sigmoid disparities (and
    masks) at every scale, small poses."""
    n = len(cfg.frame_ids) - 1
    out = {}
    for s in cfg.scales:
        out[("disp", s)] = rng.uniform(0.05, 0.95, (B, H >> s, W >> s, 1))
        if cfg.predictive_mask:
            out[("mask", s)] = rng.uniform(0.05, 0.95,
                                           (B, H >> s, W >> s, n))
    for f in SRC:
        out[("axisangle", 0, f)] = rng.normal(0, 0.01, (B, 2, 1, 3))
        out[("translation", 0, f)] = rng.normal(0, 0.05, (B, 2, 1, 3))
    return out


def test_v1_multiscale_loss_and_grads_match_jax_f64():
    """generate_images_pred + compute_losses under v1_multiscale with the
    predictive mask (one channel per source frame), avg_reprojection and
    the L1 maps, from one outputs dict: the loss and each scale's terms to
    1e-7, the gradients with respect to every disparity, pose parameter
    and mask to rtol 1e-5 / atol 1e-9."""
    kw = V1_KW
    batch = {k: v[:, :3] if k in ("color", "color_aug", "two_channel")
             else v for k, v in stereo_inputs().items() if k != "stereo_T"}
    key = jax.random.PRNGKey(5)
    with jax.enable_x64():
        cfg = JaxConfig(**kw, pallas_warp=False)
        leaves = v1_outputs(cfg, np.random.default_rng(4))
        from fusiondepth_tpu.ops.pose import \
            transformation_from_parameters as jax_T

        def loss_of(leaves, batch):
            out = {}
            for k, v in leaves.items():
                if k[0] == "mask":
                    out.setdefault("predictive_mask", {})[("disp", k[1])] = v
                else:
                    out[k] = v
            for f in SRC:
                out[("cam_T_cam", 0, f)] = jax_T(
                    out[("axisangle", 0, f)][:, 0, 0],
                    out[("translation", 0, f)][:, 0, 0], invert=f < 0)
            batch = dict(batch, color_pyramid=jax_photometric.
                         build_color_pyramid(cfg, batch["color"][:, 0]))
            out = jax_photometric.generate_images_pred(
                cfg, batch, out, list(cfg.frame_ids))
            losses = jax_photometric.compute_losses(cfg, batch, out, key)
            return losses["loss"], losses

        (loss, losses), grads = jax.tree.map(np.asarray, jit(
            jax.value_and_grad(loss_of, has_aux=True))(
            {k: jnp.asarray(v) for k, v in leaves.items()},
            {k: jnp.asarray(v) for k, v in batch.items()}))

    pcfg = Config(**kw)
    ours = {k: torch.tensor(v, requires_grad=True) for k, v in leaves.items()}
    out = {k: v for k, v in ours.items() if k[0] != "mask"}
    if pcfg.predictive_mask:
        out["predictive_mask"] = {("disp", k[1]): v for k, v in ours.items()
                                  if k[0] == "mask"}
    from fusiondepth_torch.ops.pose import transformation_from_parameters
    for f in SRC:
        out[("cam_T_cam", 0, f)] = transformation_from_parameters(
            out[("axisangle", 0, f)][:, 0, 0],
            out[("translation", 0, f)][:, 0, 0], invert=f < 0)
    tb = device_batch(batch, CPU, TRAIN_KEYS, torch.float64)
    out = photometric.generate_images_pred(pcfg, tb, out)
    got = photometric.compute_losses(pcfg, tb, out)
    got["loss"].backward()
    assert set(got) == set(losses)
    for k in losses:
        assert abs(got[k].item() - float(losses[k])) < 1e-7, k
    for k, t in ours.items():
        np.testing.assert_allclose(t.grad.numpy(), grads[k], rtol=1e-5,
                                   atol=1e-9, err_msg=str(k))


# ---- evaluate: visualize, per_semantic, benchmark ----

@pytest.fixture(scope="module")
def fixture_drive(tmp_path_factory):
    """The JAX fixture's 3-frame drive (64x96 network size, 128x192
    native) with each frame's velodyne ground truth."""
    root = str(tmp_path_factory.mktemp("drive"))
    build_synthetic_kitti_tree(root)
    date, drive = "2011_09_26", "2011_09_26/2011_09_26_drive_0001_sync"
    gts = [generate_depth_map(
        os.path.join(root, date),
        os.path.join(root, drive, "velodyne_points/data", f"{i:010d}.bin"),
        2, vel_depth=True) for i in range(3)]
    return root, drive, gts


class GroundTruth:
    def __init__(self, gts):
        self.gts = gts

    def __len__(self):
        return len(self.gts)

    def __getitem__(self, i):
        return {"depth_gt": self.gts[i]}


def test_evaluate_branches_match_jax(fixture_drive, tmp_path, monkeypatch):
    """evaluate over ext_disp_to_eval disparities of the fixture drive's
    frames, in the port and the JAX package: visualize (MAGMA PNGs, byte
    for byte), per_semantic (over mask PNGs written here; each class's 7
    metrics to 1e-12) with the same metrics, and eval_split="benchmark"
    (the uint16 PNGs, byte for byte, and no metrics)."""
    _, _, gts = fixture_drive
    rng = np.random.default_rng(6)
    disps = np.array([rng.uniform(0.01, 0.3, (H, W)) .astype(np.float32)
                      for _ in gts])
    ext = str(tmp_path / "disps.npy")
    np.save(ext, disps)
    masks = tmp_path / "masks"
    masks.mkdir()
    for i, gt in enumerate(gts):
        Image.fromarray(rng.integers(0, 34, gt.shape).astype(np.uint8)).save(
            masks / f"pred_mask{i}.png")
    per_class = {}
    for name, mod in (("jax", jax_eval), ("port", eval_driver)):
        def recorded(*a, _f=mod.evaluate_per_semantic, _n=name):
            per_class[_n] = _f(*a)
            return per_class[_n]
        monkeypatch.setattr(mod, "evaluate_per_semantic", recorded)

    results = {}
    for name, cls, ev in (("jax", JaxConfig, jax_eval.evaluate),
                          ("port", Config, eval_driver.evaluate)):
        log = tmp_path / name
        kw = dict(height=H, width=W, ext_disp_to_eval=ext,
                  semantic_mask_path=str(masks), log_dir=str(log))
        metrics = ev(cls(**kw, visualize=True, vis_name="_v",
                         per_semantic=True), GroundTruth(gts))
        bench = ev(cls(**kw, eval_split="benchmark"), GroundTruth(gts))
        assert bench is None
        files = {}
        for sub in ("visualization", "benchmark_predictions"):
            names = sorted(os.listdir(log / sub))
            files[sub] = {n: (log / sub / n).read_bytes() for n in names}
        results[name] = metrics, files
    (m_jax, f_jax), (m_port, f_port) = results["jax"], results["port"]
    assert m_port.keys() == m_jax.keys()
    for k in m_jax:
        assert abs(m_port[k] - m_jax[k]) < 1e-12, k
    assert sorted(f_port["visualization"]) == [f"{i}_vdepth.png"
                                               for i in range(len(gts))]
    assert sorted(f_port["benchmark_predictions"]) == [
        f"{i:010d}.png" for i in range(len(gts))]
    assert f_port == f_jax
    assert per_class["port"].shape == (34, 7)
    assert np.count_nonzero(per_class["port"][:, 0]) > 30
    np.testing.assert_allclose(per_class["port"], per_class["jax"],
                               atol=1e-12, rtol=0)


# ---- the host data-prep CLIs ----

def run_root_script(name, argv, monkeypatch, path=None):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(path or os.path.join(REPO, name), run_name="__main__")


def tree_files(root, subdirs):
    out = {}
    for sub in subdirs:
        for dirpath, _, names in os.walk(os.path.join(root, sub)):
            for n in names:
                p = os.path.join(dirpath, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_host_clis_write_the_root_scripts_files(fixture_drive, tmp_path,
                                                monkeypatch):
    """python -m fusiondepth_torch.{sparsify,gen2channel,
    gen2channel_detec,export_gt_depth} against the root scripts of those
    names, each with the same flags on its own copy of the fixture drive:
    the same K-beam bins, 2-channel npy files and ground-truth arrays. The
    port keeps only the numpy path of the projection and the expansion, so
    the root scripts run the JAX package's numpy path too (its C++ fast
    path rounds some means 1 ulp apart)."""
    import fusiondepth_tpu.native

    for fast in ("expand_two_channel_native", "project_points_native"):
        monkeypatch.setattr(fusiondepth_tpu.native, fast, lambda *a: None)
    src, drive, _ = fixture_drive
    split = tmp_path / "files.txt"
    split.write_text("".join(f"{drive} {i} l\n" for i in range(3)))
    detec = tmp_path / "detec.txt"
    detec.write_text("".join(f"{i}\n" for i in range(3)))
    roots = {}
    for name in ("root", "port"):
        root = str(tmp_path / name / "data")
        shutil.copytree(src, root)
        # the detection layout: a 375x1242 capture (2011_09_26's shape),
        # the drive's 4-beam bins under 6-digit ids
        det = os.path.join(root, "kitti_detect/training")
        os.makedirs(os.path.join(det, "image_02/data"))
        os.makedirs(os.path.join(det, "4beam"))
        for i in range(3):
            Image.fromarray(np.zeros((375, 1242), np.uint8)).save(
                os.path.join(det, "image_02/data", f"{i:06d}.png"))
            shutil.copy(os.path.join(root, drive, "4beam", f"{i:010d}.bin"),
                        os.path.join(det, "4beam", f"{i:06d}.bin"))
        splits = tmp_path / name / "splits" / "fixture"
        splits.mkdir(parents=True)
        (splits / "test_files.txt").write_text(split.read_text())
        roots[name] = root
    argvs = [
        ("sparsify.py", port_sparsify,
         ["--split_file", str(split), "--nbeams", "2"]),
        ("sparsify.py", port_sparsify,
         ["--split_file", str(split), "--random_sample", "500"]),
        ("gen2channel.py", port_gen2channel,
         ["--split_file", str(split), "--nbeams", "2"]),
        ("gen2channel_detec.py", port_gen2channel_detec,
         ["--split_file", str(detec)]),
        ("export_gt_depth.py", port_export_gt_depth,
         ["--split", "fixture", "--export_4beam"]),
    ]
    # the root export_gt_depth.py writes beside itself: run a copy
    root_export = tmp_path / "root" / "export_gt_depth.py"
    shutil.copy(os.path.join(REPO, "export_gt_depth.py"), root_export)
    monkeypatch.setattr(port_export_gt_depth, "SPLITS_DIR",
                        str(tmp_path / "port" / "splits"))
    for script, mod, argv in argvs:
        run_root_script(script, argv + ["--data_path", roots["root"]],
                        monkeypatch, str(root_export)
                        if script == "export_gt_depth.py" else None)
        assert mod.main(argv + ["--data_path", roots["port"]]) > 0, script
    subdirs = [os.path.join(drive, d) for d in
               ("2beam", "random500", "2channel2beam")] + [
        "kitti_detect/training/2channel"]
    want, got = (tree_files(roots[n], subdirs) for n in ("root", "port"))
    assert len(want) == 3 + 3 + 6 + 6
    assert got == want
    for f in ("gt_depths.npz", "4beam.npz"):
        with np.load(tmp_path / "root" / "splits" / "fixture" / f,
                     allow_pickle=True) as a, \
                np.load(tmp_path / "port" / "splits" / "fixture" / f,
                        allow_pickle=True) as b:
            assert len(a["data"]) == len(b["data"]) == 3
            for x, y in zip(a["data"], b["data"]):
                np.testing.assert_array_equal(x, y)


# ---- whole steps (their JAX sides computed meanwhile) ----

@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_step(request, jax_variant_sides):
    return jax_variant_sides["steps"].result()[request.param]


def test_variant_step_matches_jax_f64(jax_step):
    """One train_step of configuration A or B: the training-mode forward
    it runs (disparities, poses, masks) and A's automask selection maps,
    its loss, every gradient leaf,
    and the parameters and BN statistics after the Adam update. The
    beam-pose encoder is in both trees and read by neither configuration:
    JAX's gradient there is 0, the port's None (A has none)."""
    cfg = Config(**jax_step["kw"])
    nets = FusionNets(cfg, device=CPU)
    nets.load_state_dict(from_jax_variables(jax_step["variables"]))
    forward, seen = nets.forward, {}

    def recording_forward(*args, **kwargs):
        seen["out"] = forward(*args, **kwargs)
        return seen["out"]

    nets.forward = recording_forward
    opt, sched = make_optimizer(cfg, nets, STEPS_PER_EPOCH)
    losses = train_step(cfg, nets, opt, sched,
                        device_batch(jax_step["batch"], CPU, TRAIN_KEYS,
                                     torch.float64),
                        noise=jax_step["noise"])
    for (name, get), want in zip(forward_keys(cfg), jax_step["fwd"]):
        got = get(seen["out"]).detach().numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0,
                                   err_msg=name)
    assert abs(float(losses["loss"]) - jax_step["loss"]) < 1e-7, (
        float(losses["loss"]), jax_step["loss"])
    unread = {n for n, p in nets.named_parameters() if p.grad is None}
    assert unread == ({n for n, _ in nets.beam_encoder_pose.named_parameters(
        prefix="beam_encoder_pose")} if cfg.beam_encoder else set())
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in nets.named_parameters()}
    assert_trees_close({k: v["params"]
                        for k, v in to_jax_variables(grads).items()},
                       jax_step["grads"], rtol=1e-5, atol=1e-9)
    got = to_jax_variables(nets.state_dict())
    assert_trees_close({k: v["params"] for k, v in got.items()},
                       jax_step["new_params"], rtol=0, atol=1e-6)
    assert_trees_close({k: v["batch_stats"] for k, v in got.items()
                        if "batch_stats" in v},
                       {k: v for k, v in jax_step["new_stats"].items() if v},
                       rtol=0, atol=1e-9)
