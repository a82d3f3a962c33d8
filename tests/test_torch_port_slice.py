"""The whole stage-1 depth-inference slice of the port against the JAX
package: FusionNets.forward_depth, Infer.run_split and
predict_disparities(post_process=True), on the same numpy-made batch and
the same weights (JAX default flags, carried by
models/jax_weights.from_jax_variables and, for the drivers, through a
.npz weights folder).

float64 on both sides (jax.enable_x64, compute_dtype="float64"), as
tests/test_refiner_torch_parity.py runs its oracle: the two sides differ
only by summation order, so every disparity agrees to atol 1e-9. The
inference cache stores float32 files, so those are held to one float32
rounding (atol 1e-7).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config
from fusiondepth_tpu.data.synthetic import SyntheticDataset, make_batch
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.training.evaluation import flip_postprocess
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import NETS, flatten, \
    from_jax_variables
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.eval_driver import predict_disparities
from fusiondepth_torch.training.infer_driver import Infer, device_batch

from test_torch_port_models import random_variables

B, H, W = 2, 64, 96
CFG = Config(num_layers=18, height=H, width=W, compute_dtype="float64",
             weights_init="scratch", eval_batch_size=B)
CPU = torch.device("cpu")
# what the JAX eval driver mirrors for the flip post-process
# (fusiondepth_tpu/training/eval_driver.py:62-67)
JAX_FLIP_KEYS = ("color", "color_aug", "two_channel", "four_beam")


def _f64(batch):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in batch.items()}


class FramesDataset:
    """SyntheticDataset frames in float64, with the parse_line of a KITTI
    split so the inference cache can name its files."""

    def __init__(self, n):
        self.inner = SyntheticDataset(CFG, length=n, seed=3)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return _f64(self.inner[i])

    def parse_line(self, i):
        return "2011_09_26/drive_0001_sync", 10 + i, "l"

    def batches(self):
        for s in range(0, len(self), B):
            yield {k: np.stack([self[i][k] for i in range(s, s + B)])
                   for k in self[0]}


@pytest.fixture(scope="module")
def jax_side():
    """JAX variables and every JAX result the tests compare with."""
    frames = FramesDataset(4)
    batch = _f64(make_batch(CFG, B, seed=0))
    with jax.enable_x64():
        nets = JaxFusionNets(CFG)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0)),
                             np.random.default_rng(0), np.float64)

        # jitted: one compile of the whole forward costs less on a CPU
        # than the eager per-op compiles (about 17 s against 38 s)
        fwd_fn = jax.jit(lambda b: nets.forward_depth(v, b, train=False)[0])

        def disp(b):
            out = fwd_fn({k: jnp.asarray(x) for k, x in b.items()})
            return {k: np.asarray(x) for k, x in out.items()}

        fwd = disp(batch)
        frame_disp, post = [], []
        for b in frames.batches():
            d = disp(b)[("disp", 0)][..., 0]
            flipped = {k: (x[..., ::-1, :] if k in JAX_FLIP_KEYS else x)
                       for k, x in b.items()}
            d_f = disp(flipped)[("disp", 0)][..., 0]
            frame_disp.extend(d)
            post.extend(flip_postprocess(d, d_f[:, :, ::-1]))
    return dict(variables={k: v[k] for k in NETS if k in v}, batch=batch,
                fwd=fwd, frames=frames, frame_disp=frame_disp, post=post)


@pytest.fixture(scope="module")
def port_nets(jax_side):
    nets = FusionNets(CFG, device=CPU)
    nets.load_state_dict(from_jax_variables(jax_side["variables"]))
    return nets


def test_forward_depth_matches_jax_f64(jax_side, port_nets):
    with torch.no_grad():
        out, feats = port_nets.forward_depth(
            device_batch(jax_side["batch"], CPU), train=False)
    want = jax_side["fwd"]
    assert set(out) == set(want) == {("disp", s) for s in CFG.scales}
    for k in want:
        assert out[k].dtype == torch.float64
        assert tuple(out[k].shape) == want[k].shape == (
            B, H >> k[1], W >> k[1], 1)
        np.testing.assert_allclose(out[k].numpy(), want[k], atol=1e-9,
                                   rtol=0, err_msg=str(k))
    assert [f.shape[1] for f in feats] == [64, 64, 128, 256, 512]


def test_forward_depth_variant_matches_jax():
    """The fusion variants of the depth branch, all in one configuration
    to keep to one JAX compile: the LiDAR concatenated to the encoder
    input, no beam encoder, the LiDAR at the last head, and the
    predictive-mask decoder."""
    cfg = CFG.replace(cat2start=True, cat2end=True, beam_encoder=False,
                      predictive_mask=True, disable_automasking=True)
    batch = _f64(make_batch(cfg, B, seed=1))
    with jax.enable_x64():
        jnets = JaxFusionNets(cfg)
        v = random_variables(lambda: jnets.init(jax.random.PRNGKey(0)),
                             np.random.default_rng(1), np.float64)

        def fwd(b):
            # the disparities and the mask apart: a pytree's dict keys
            # must sort, and ("disp", 0) and "predictive_mask" do not
            out = jnets.forward_depth(v, b, train=False)[0]
            mask = out.pop("predictive_mask", {})
            return out, mask

        want = jax.tree.map(np.asarray, jax.jit(fwd)(
            {k: jnp.asarray(x) for k, x in batch.items()}))
    nets = FusionNets(cfg, device=CPU)
    nets.load_state_dict(from_jax_variables({k: v[k] for k in NETS
                                             if k in v}))
    with torch.no_grad():
        got, _ = nets.forward_depth(device_batch(batch, CPU))
    got_mask = got.pop("predictive_mask", {})
    assert set(got) == set(want[0]) and set(got_mask) == set(want[1])
    assert bool(got_mask) == cfg.predictive_mask
    pairs = [(got[k], want[0][k], str(k)) for k in want[0]]
    pairs += [(got_mask[k], want[1][k], f"mask {k}") for k in want[1]]
    for g, w, name in pairs:
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-9, rtol=0,
                                   err_msg=name)


def test_infer_run_split_matches_jax(jax_side, tmp_path):
    weights = tmp_path / "weights_0"
    weights.mkdir()
    np.savez(weights / ckpt.JAX_FILE, **flatten(jax_side["variables"]))
    cfg = CFG.replace(load_weights_folder=str(weights))
    frames = jax_side["frames"]
    infer = Infer(cfg, device=CPU)
    assert infer.run_split(frames, str(tmp_path)) == len(frames)
    for i, want in enumerate(jax_side["frame_disp"]):
        folder, idx, side = frames.parse_line(i)
        got = np.load(tmp_path / folder / "inf_depth_4beam" /
                      f"{idx}_{side}.npy")
        assert got.shape == (1, 1, H, W) and got.dtype == np.float32
        np.testing.assert_allclose(got[0, 0], want, atol=1e-7, rtol=0)


def test_predict_disparities_post_process_matches_jax(jax_side, port_nets):
    cfg = CFG.replace(post_process=True)
    disps, gts = predict_disparities(cfg, jax_side["frames"], nets=port_nets)
    assert len(disps) == len(jax_side["post"]) and gts == []
    for got, want in zip(disps, jax_side["post"]):
        assert got.shape == (H, W)
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


def test_checkpoint_round_trip(port_nets, tmp_path):
    cfg = CFG.replace(log_dir=str(tmp_path))
    ckpt.save_options(cfg)
    path = ckpt.save_checkpoint(cfg, port_nets, "0")
    fresh = FusionNets(cfg, device=CPU,
                       generator=torch.Generator().manual_seed(1))
    meta = ckpt.load_checkpoint(path, fresh)
    assert meta["num_layers"] == 18 and meta["height"] == H
    assert os.path.exists(tmp_path / cfg.model_name / "models" / "opt.json")
    for k, v in port_nets.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
