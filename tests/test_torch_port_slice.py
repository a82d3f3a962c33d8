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

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.data.synthetic import SyntheticDataset, make_batch
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from fusiondepth_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from fusiondepth_tpu.training.evaluation import flip_postprocess
from fusiondepth_tpu.training.train_state import TrainState, \
    combine_variables, split_variables
from fusiondepth_tpu.training.train_state import \
    make_optimizer as jax_make_optimizer
from fusiondepth_torch.config import Config
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import NETS, flatten, \
    from_jax_variables
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.eval_driver import predict_disparities
from fusiondepth_torch.training.infer_driver import Infer, device_batch

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import jit, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 96
# the JAX Config and the port's from the same keyword arguments
KW = dict(num_layers=18, height=H, width=W, compute_dtype="float64",
          weights_init="scratch", eval_batch_size=B)
CFG = Config(**KW)
JCFG = JaxConfig(**KW)
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
        self.inner = SyntheticDataset(JCFG, length=n, seed=3)

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
    batch = _f64(make_batch(JCFG, B, seed=0))
    with jax.enable_x64():
        nets = JaxFusionNets(JCFG)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0)),
                             np.random.default_rng(0), np.float64)

        # jitted: one compile of the whole forward costs less on a CPU
        # than the eager per-op compiles (about 17 s against 38 s); the
        # weights are an argument, not constants folded into the program
        fwd_fn = jit(lambda v, b: nets.forward_depth(v, b, train=False)[0])

        def disp(b):
            out = fwd_fn(v, {k: jnp.asarray(x) for k, x in b.items()})
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
                fwd=fwd, frames=frames, frame_disp=frame_disp, post=post,
                fwd_fn=fwd_fn)


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
    variant = dict(cat2start=True, cat2end=True, beam_encoder=False,
                   predictive_mask=True, disable_automasking=True)
    cfg, jcfg = CFG.replace(**variant), JCFG.replace(**variant)
    batch = _f64(make_batch(jcfg, B, seed=1))
    with jax.enable_x64():
        jnets = JaxFusionNets(jcfg)
        v = random_variables(lambda: jnets.init(jax.random.PRNGKey(0)),
                             np.random.default_rng(1), np.float64)

        def fwd(v, b):
            # the disparities and the mask apart: a pytree's dict keys
            # must sort, and ("disp", 0) and "predictive_mask" do not
            out = jnets.forward_depth(v, b, train=False)[0]
            mask = out.pop("predictive_mask", {})
            return out, mask

        want = jax.tree.map(np.asarray, jit(fwd)(
            v, {k: jnp.asarray(x) for k, x in batch.items()}))
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


# ---- checkpoint interchange (scripts/convert_checkpoint.py) ----

def convert(*argv):
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", os.path.join(REPO, "scripts",
                                           "convert_checkpoint.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(list(argv)) == 0


def fresh(tx, params):
    """tx.init(params), made in numpy from its shapes (zero moments,
    counts 0)."""
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        jax.eval_shape(tx.init, params))


def jax_state(variables, step):
    params, stats = split_variables(variables)
    return TrainState(params, stats, fresh(jax_make_optimizer(JCFG, 1),
                                           params),
                      jnp.asarray(step, jnp.int32))


def test_jax_checkpoint_converts_to_the_port(jax_side, tmp_path):
    """JAX save_checkpoint -> convert to-port -> the port's
    load_checkpoint: forward_depth gives the JAX forward's disparities."""
    with jax.enable_x64():
        src = jax_save_checkpoint(JCFG.replace(log_dir=str(tmp_path)),
                                  jax_state(jax_side["variables"], 7), "0")
        convert("to-port", src, str(tmp_path / "port"))
    nets = FusionNets(CFG, device=CPU,
                      generator=torch.Generator().manual_seed(1))
    meta = ckpt.load_checkpoint(str(tmp_path / "port"), nets)
    assert meta["step"] == 7 and meta["height"] == H
    with torch.no_grad():
        out, _ = nets.forward_depth(device_batch(jax_side["batch"], CPU))
    for k, want in jax_side["fwd"].items():
        np.testing.assert_allclose(out[k].numpy(), want, atol=1e-9,
                                   rtol=0, err_msg=str(k))


def test_port_checkpoint_converts_to_jax(jax_side, port_nets, tmp_path):
    """The port's save_checkpoint -> convert to-jax -> the JAX
    load_checkpoint restores every leaf, and its forward gives the same
    disparities; the optimizer state is a fresh Adam at the saved step."""
    cfg = CFG.replace(log_dir=str(tmp_path))
    src = ckpt.save_checkpoint(cfg, port_nets, "p", step=11)
    dst = str(tmp_path / "jax" / "weights_p")
    convert("to-jax", src, dst)
    with jax.enable_x64():
        template = jax_state(jax.tree.map(np.zeros_like,
                                          jax_side["variables"]), 0)
        state, meta = jax_load_checkpoint(dst, template)
        assert meta["step"] == 11 and int(state.step) == 11
        adam, schedule = state.opt_state
        assert int(schedule.count) == 11 and int(adam.count) == 0
        assert not any(np.asarray(m).any()
                       for m in jax.tree.leaves(adam.mu))
        got = jax.tree.map(np.asarray, jax_side["fwd_fn"](
            combine_variables(state.params, state.batch_stats),
            {k: jnp.asarray(x) for k, x in jax_side["batch"].items()}))
    for k, want in jax_side["fwd"].items():
        np.testing.assert_allclose(got[k], want, atol=1e-9, rtol=0,
                                   err_msg=str(k))


def test_jax_refiner_bundle_converts_to_the_port(jax_side, tmp_path):
    """A JAX refiner bundle with train_entire_net (refine_params,
    opt_state and stage1_variables, the tree the JAX Refiner.save saves)
    -> convert to-port -> the port's Refiner.load: the refine decoder and
    the fine-tuned stage-1 nets carry every leaf. The refine decoder's
    variables are the port decoder's own init in the JAX layout (the flax
    init's tree; tests/test_torch_port_refiner.py holds the decoders
    equal), zeroed in the port before the load."""
    import optax
    import orbax.checkpoint as ocp

    from fusiondepth_torch.models.jax_weights import to_jax_variables
    from fusiondepth_torch.training.refiner_driver import Refiner

    cfg = CFG.replace(train_entire_net=True, log_dir=str(tmp_path),
                      batch_size=B)
    refiner = Refiner(cfg, device="cpu")
    refine_params = to_jax_variables(refiner.nets.refine2d.state_dict(
        prefix="refine2d."))["refine2d"]
    with torch.no_grad():
        for t in refiner._bundle().state_dict().values():
            t.zero_()
    with jax.enable_x64():
        stage1 = jax_side["variables"]
        trainable = {"refine": refine_params,
                     "stage1": {k: v["params"] for k, v in stage1.items()}}
        bundle = {"refine_params": refine_params,
                  "opt_state": fresh(optax.adam(1e-4), trainable),
                  "stage1_variables": stage1}
        src = str(tmp_path / "jax_refine" / "weights_best_refine")
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(src, bundle, force=True)
        ckptr.wait_until_finished()
    convert("to-port", src, str(tmp_path / "port_refine"))
    refiner.load(str(tmp_path / "port_refine"))
    got = to_jax_variables(refiner._bundle().state_dict())
    want = {"refine2d": refine_params, **stage1}
    assert set(got) == set(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# ---- Trainer.validate's sample images ----

@pytest.mark.parametrize("flag", ["save_sample", "visualize"])
def test_trainer_validate_logs_the_jax_sample_images(flag, jax_side,
                                                     tmp_path):
    """With save_sample or visualize, Trainer.validate writes the first
    batch's frame-0 disparity (over its max) and colour image as
    disp_0_{step}.png and color_0_{step}.png, the files the JAX trainer's
    validate writes through its logger (without TensorBoard) from the
    JAX disparity of the same frame: byte-equal."""
    from fusiondepth_tpu.utils.logging import MetricLogger as JaxLogger
    from fusiondepth_torch.training.trainer import Trainer

    frames = jax_side["frames"]
    cfg = CFG.replace(log_dir=str(tmp_path / "port"), batch_size=B,
                      **{flag: True})
    trainer = Trainer(cfg, train_dataset=frames, val_dataset=frames,
                      device="cpu")
    trainer.nets.load_state_dict(from_jax_variables(jax_side["variables"]))
    trainer.step = 3
    assert trainer.validate() is None  # the frames carry no depth_gt
    jax_log = JaxLogger(str(tmp_path / "jax"), "val", use_tb=False)
    d = jax_side["frame_disp"][0]
    jax_log.log_image(3, "disp_0", d / max(float(d.max()), 1e-9))
    jax_log.log_image(3, "color_0", frames[0]["color"][0])
    port_dir = tmp_path / "port" / cfg.model_name / "val"
    for name in ("disp_0_3.png", "color_0_3.png"):
        got = (port_dir / name).read_bytes()
        assert got == (tmp_path / "jax" / "val" / name).read_bytes(), name
    assert sorted(p.name for p in port_dir.glob("*.png")) == [
        "color_0_3.png", "disp_0_3.png"]
