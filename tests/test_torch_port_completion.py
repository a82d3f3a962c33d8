"""Depth completion in the port (fusiondepth_torch) against the JAX
package, on the CPU:

- `KITTICompletion` samples, `bottom_crop`, `discover_paths` and
  `load_depth_png` on a 3-frame 375x1242 PNG tree built like
  tests/test_completion.py's: the same keys, shapes and values;
- `FusionNets(num_layers=50, pose_depth=18)`: the R50 depth branch and the
  R18 pose encoders' poses in float64 at 64x96, batch 1, to 1e-9, with the
  weights carried across by models/jax_weights (both ways);
- `completion_loss` and every gradient leaf in float64 against
  `make_completion_loss_fn` at completion_num_layers=18, 64x96, batch 2,
  with the SI term and with the L1 term, replaying JAX's automask noise:
  the loss to 1e-7 absolute, the gradients to rtol 1e-5, atol 1e-9 (the
  bounds of tests/test_torch_port_train.py, for the same reasons);
- `make_completion_optimizer`'s learning rate around each boundary
  against optax's schedule, and `completion_metrics` against JAX's;
- one `Completor.run_step` and `validate` on the CPU, the
  evaluate_completion CLI (metrics and the 16-bit PNG export) and the
  host-only gen2cha_completion CLI on the CPU, and the card that
  `Completor` and the other completion CLIs need.

The JAX side of the loss is one jitted function (both terms, one traced
forward), computed once per module. The JAX sides run the JAX package's
generic path (its TPU layout flags off, test_torch_port_models.GENERIC).
"""

import os

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.data import completion_dataset as jax_cd
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.training import completor as jax_completor
from fusiondepth_tpu.training.train_state import split_variables
from fusiondepth_torch.config import Config
from fusiondepth_torch.data import completion_dataset as cd
from fusiondepth_torch.data.loader import collate
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.models import jax_weights
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import (
    NETS,
    from_jax_variables,
    to_jax_variables,
)
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.completor import (
    Completor,
    completion_loss,
    completion_metrics,
    make_completion_optimizer,
)
from fusiondepth_torch.training.infer_driver import device_batch
from fusiondepth_torch.training.trainer import TRAIN_KEYS

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jax_sides_in_threads, jit, \
    random_variables
from test_torch_port_train import assert_trees_close, make_inputs

B, H, W = 2, 64, 96
KW = dict(num_layers=18, completion_num_layers=18,
          completion_pose_num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch")
# the two completion terms: SI (the default) and masked L1
TERMS = {"si": {}, "l1": dict(completion_siloss=False,
                              completion_l1loss=True)}
CPU = torch.device("cpu")
POSE_KEYS = [(k, 0, f) for f in (-1, 1)
             for k in ("axisangle", "translation", "cam_T_cam")]


# ---- the dataset ----

@pytest.fixture(scope="module")
def completion_tree(tmp_path_factory):
    """3 consecutive frames of one drive in the completion layout, at
    KITTI's native 375 x 1242 (tests/test_completion.py's tree)."""
    root = tmp_path_factory.mktemp("completion")
    drive = "2011_09_26_drive_0001_sync"
    rgb_dir = root / "data_rgb" / "train" / drive / "image_02" / "data"
    d_dir = (root / "data_depth_velodyne" / "train" / drive / "proj_depth"
             / "velodyne_raw" / "image_02")
    gt_dir = (root / "data_depth_annotated" / "train" / drive / "proj_depth"
              / "groundtruth" / "image_02")
    for d in (rgb_dir, d_dir, gt_dir):
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.uniform(0, 255, (375, 1242, 3)).astype(np.uint8)
        Image.fromarray(img).save(rgb_dir / f"{i:010d}.png")
        for folder in (d_dir, gt_dir):
            sparse = np.zeros((375, 1242), np.uint16)
            hits = rng.uniform(size=sparse.shape) < 0.05
            sparse[hits] = (rng.uniform(2, 80, hits.sum()) * 256).astype(
                np.uint16)
            Image.fromarray(sparse).save(folder / f"{i:010d}.png")
    return str(root)


def test_paths_crop_and_depth_png_match_jax(completion_tree):
    for verify in (True, False):
        got = cd.discover_paths(completion_tree, "train", verify=verify)
        assert got == jax_cd.discover_paths(completion_tree, "train",
                                            verify=verify)
    assert len(got["rgb"]) == 3 and len(
        cd.discover_paths(completion_tree, "train")["rgb"]) == 1
    x = np.random.default_rng(1).uniform(size=(375, 1242, 2))
    np.testing.assert_array_equal(cd.bottom_crop(x), jax_cd.bottom_crop(x))
    assert cd.bottom_crop(x).shape == (cd.CROP_H, cd.CROP_W, 2)
    d = cd.load_depth_png(got["d"][0])
    assert d.dtype == np.float32
    np.testing.assert_array_equal(d, jax_cd.load_depth_png(got["d"][0]))


@pytest.mark.parametrize("is_train", [True, False])
def test_kitti_completion_samples_match_jax(completion_tree, is_train):
    """Train samples (frames 0, -1, 1 of the middle frame, the seeded
    flip and colour jitter drawn alike) and val samples over the train
    paths, need_path on."""
    kw = dict(need_path=True)
    paths = None if is_train else cd.discover_paths(completion_tree, "train")
    ours = cd.KITTICompletion(completion_tree, is_train=is_train,
                              cfg=Config(**kw), seed=3, paths=paths)
    ref = jax_cd.KITTICompletion(completion_tree, is_train=is_train,
                                 cfg=JaxConfig(**kw), seed=3, paths=paths)
    assert len(ours) == len(ref) == 1
    for _ in range(2):  # two draws of the augmentation
        got, want = ours[0], ref[0]
        assert got.keys() == want.keys()
        assert {"color", "color_aug", "two_channel", "four_beam", "K",
                "inv_K", "depth_gt", "path"} <= set(got)
        for k in want:
            if k == "path":
                assert got[k] == want[k]
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    frames = 3 if is_train else 1
    assert got["color"].shape == (frames, 352, 1216, 3)
    assert got["two_channel"].shape == (frames, 352, 1216, 2)


# ---- the model: R50 depth branch, R18 pose encoders ----

def jax_pose_depth_forward():
    """The JAX eval-mode forward of FusionNets(num_layers=50,
    pose_depth=18) on one row: (its disparities and poses, its variables,
    the row)."""
    kw = dict(KW, num_layers=50, batch_size=1)
    batch = {k: v[:1] for k, v in make_inputs().items()}
    with jax.enable_x64():
        cfg = JaxConfig(**kw, pallas_warp=False, **GENERIC)
        nets = JaxFusionNets(cfg, pose_depth=18)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0),
                                               batch_size=1),
                             np.random.default_rng(1), np.float64)

        def forward(v, b):
            out, _ = nets.forward(v, b, train=False)
            return [out[("disp", s)] for s in cfg.scales] + [
                out[k] for k in POSE_KEYS]

        want = jax.tree.map(np.asarray, jit(forward)(
            v, {k: jnp.asarray(x) for k, x in batch.items()}))
    return want, {k: v[k] for k in NETS if k in v}, batch


@pytest.fixture(scope="module", autouse=True)
def jax_sides():
    """The module's two JAX sides, the R50/R18 forward and the loss
    fixture's step, under way in two threads from the module's first test
    on (XLA's compile releases the GIL; under pytest-xdist from the test
    that reads one: `JaxSides`), while the tests that read neither run."""
    with jax_sides_in_threads(
            pose_depth=lambda sides: jax_pose_depth_forward(),
            loss=lambda sides: jax_loss_side()) as sides:
        yield sides


def test_pose_depth_forward_matches_jax_f64(jax_sides):
    """FusionNets(num_layers=50, pose_depth=18): disparities and poses of
    the eval-mode forward to 1e-9, and the weights carried both ways."""
    kw = dict(KW, num_layers=50, batch_size=1)
    want, variables, batch = jax_sides["pose_depth"].result()
    ours = FusionNets(Config(**kw), device=CPU, pose_depth=18)
    assert ours.pose_encoder.depth == ours.beam_encoder_pose.depth == 18
    assert ours.encoder.depth == ours.beam_encoder.depth == 50
    assert ours.pose.squeeze.in_channels == 512
    ours.load_state_dict(from_jax_variables(variables))
    back = jax_weights.flatten(to_jax_variables(ours.state_dict()))
    want_flat = jax_weights.flatten(variables)
    assert back.keys() == want_flat.keys()
    for k, w in want_flat.items():
        assert np.array_equal(back[k], w), k
    with torch.no_grad():
        out = ours(device_batch(batch, CPU, TRAIN_KEYS, torch.float64),
                   train=False)
    got = [out[("disp", s)] for s in range(4)] + [out[k] for k in POSE_KEYS]
    for g, w, name in zip(got, want, [f"disp {s}" for s in range(4)]
                          + POSE_KEYS):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-9, rtol=0,
                                   err_msg=str(name))


# ---- the loss and its gradients ----

@pytest.fixture(scope="module")
def jax_loss(jax_sides):
    return jax_sides["loss"].result()


def jax_loss_side():
    """make_completion_loss_fn's loss, its terms and its gradients with
    each completion term, and the automask noise it drew. One jitted
    function: the two loss functions share one traced forward (the
    training-mode forward is the same for both), and one vmapped backward
    gives each its gradients."""
    batch = make_inputs()
    with jax.enable_x64():
        cfg = JaxConfig(**KW, pallas_warp=False, **GENERIC)
        nets = JaxFusionNets(cfg, pose_depth=cfg.completion_pose_num_layers)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0),
                                               batch_size=B),
                             np.random.default_rng(0), np.float64)
        params, stats = split_variables(v)
        key = jax.random.PRNGKey(42)
        fns = [jax_completor.make_completion_loss_fn(cfg.replace(**flags),
                                                     nets)
               for flags in TERMS.values()]
        forward = nets.forward

        def run(params, stats, batch, key):
            traced = {}

            def forward_once(*args, **kwargs):
                if "out" not in traced:
                    traced["out"] = forward(*args, **kwargs)
                return traced["out"]

            def losses_of(params):
                nets.forward = forward_once
                try:
                    res = [f(params, stats, batch, key) for f in fns]
                finally:
                    del nets.forward
                return (jnp.stack([loss for loss, _ in res]),
                        [aux[0] for _, aux in res])

            loss, vjp, losses = jax.vjp(losses_of, params, has_aux=True)
            (grads,) = jax.vmap(vjp)(jnp.eye(len(fns), dtype=loss.dtype))
            return loss, losses, grads

        loss, losses, grads = jax.tree.map(np.asarray, jit(run)(
            params, stats, {k: jnp.asarray(x) for k, x in batch.items()},
            key))
        # the automask tie-break noise of photometric.py's scale loop
        noise, r = [], key
        for _ in cfg.scales:
            r, sub = jax.random.split(r)
            noise.append(torch.from_numpy(np.asarray(jax.random.normal(
                sub, (2, B, H, W))) * 1e-5))
    out = {t: (loss[i], losses[i], jax.tree.map(lambda g, i=i: g[i], grads))
           for i, t in enumerate(TERMS)}
    return dict(variables={k: v[k] for k in NETS if k in v}, batch=batch,
                out=out, noise=noise)


@pytest.mark.parametrize("term", list(TERMS))
def test_completion_loss_and_grads_match_jax_f64(jax_loss, term):
    cfg = Config(**KW, **TERMS[term])
    nets = FusionNets(cfg, device=CPU, pose_depth=18)
    nets.load_state_dict(from_jax_variables(jax_loss["variables"]))
    batch = device_batch(jax_loss["batch"], CPU, TRAIN_KEYS, torch.float64)
    loss, losses = completion_loss(cfg, nets, batch, noise=jax_loss["noise"])
    loss.backward()
    want_loss, want_losses, want_grads = jax_loss["out"][term]
    assert abs(loss.item() - float(want_loss)) < 1e-7, (loss.item(),
                                                         float(want_loss))
    key = "loss/si_loss0" if term == "si" else "loss/l1_loss0"
    assert key in losses and key in want_losses
    assert losses[key].item() > 0
    assert abs(losses[key].item() - float(want_losses[key])) < 1e-7
    grads = {n: p.grad for n, p in nets.named_parameters()}
    assert all(g is not None for g in grads.values())
    assert_trees_close({k: v["params"]
                        for k, v in to_jax_variables(grads).items()},
                       want_grads, rtol=1e-5, atol=1e-9)


# ---- the optimizer's schedule and the metrics ----

def test_completion_schedule_uses_the_raw_lr_like_optax():
    """lr unscaled by the batch (not the stage-1 lr * batch / 8), x0.1 at
    each of three boundaries of completion_scheduler_step_size epochs."""
    cfg = Config(learning_rate=1e-4, batch_size=4,
                 completion_scheduler_step_size=2)
    steps_per_epoch = 3
    boundary = 2 * steps_per_epoch
    opt, sched = make_completion_optimizer(cfg, torch.nn.Linear(2, 2),
                                           steps_per_epoch)
    want = optax.piecewise_constant_schedule(
        cfg.learning_rate, {boundary * (i + 1): 0.1 for i in range(3)})
    lrs = []
    for _ in range(4 * boundary + 2):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert lrs[0] == cfg.learning_rate
    np.testing.assert_allclose(lrs, np.asarray(want(np.arange(len(lrs)))),
                               rtol=1e-6)
    assert lrs[boundary - 1] == cfg.learning_rate
    assert lrs[boundary] == pytest.approx(cfg.learning_rate * 0.1)
    assert opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("eigen_crop", [False, True])
def test_completion_metrics_match_jax(eigen_crop):
    rng = np.random.default_rng(2)
    gt = np.where(rng.uniform(size=(352, 1216)) < 0.2,
                  rng.uniform(1.0, 80.0, (352, 1216)), 0.0).astype(np.float32)
    pred = rng.uniform(0.0, 90.0, gt.shape).astype(np.float32)
    got = completion_metrics(gt, pred, eigen_crop=eigen_crop)
    want = jax_completor.completion_metrics(gt, pred, eigen_crop=eigen_crop)
    assert got == want


# ---- the driver ----

class FramesWithGT:
    """Synthetic frames with a dense ground-truth depth map each."""

    def __init__(self, cfg, n):
        self.inner = SyntheticDataset(cfg, length=n, seed=4)
        rng = np.random.default_rng(4)
        self.gt = [rng.uniform(2.0, 60.0, (cfg.height, cfg.width))
                   .astype(np.float32) for _ in range(n)]

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return {**self.inner[i], "depth_gt": self.gt[i]}


def test_completor_step_validate_and_best_checkpoint_on_the_cpu(tmp_path):
    """completion_not_full_res (192x640), R18, batch 1: one run_step moves
    the weights with a finite loss; validate gives finite metrics, saves
    the best_completion weights, and they load back."""
    cfg = Config(completion_not_full_res=True, completion_num_layers=18,
                 batch_size=1, weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1, log_frequency=1, height=192, width=640)
    comp = Completor(cfg, train_dataset=SyntheticDataset(cfg, length=1),
                     val_dataset=FramesWithGT(cfg, 1), device="cpu")
    assert (comp.cfg.height, comp.cfg.width, comp.cfg.num_layers) == (
        192, 640, 18)
    assert comp.optimizer.param_groups[0]["lr"] == cfg.learning_rate
    before = comp.nets.depth.state_dict()["dispconv_0.conv.weight"].clone()
    losses = comp.run_step(collate([comp.train_dataset[0]]))
    assert np.isfinite(float(losses["loss"])) and "loss/si_loss0" in losses
    assert comp.step == 1
    assert not torch.equal(
        comp.nets.depth.state_dict()["dispconv_0.conv.weight"], before)
    metrics = comp.validate()
    assert set(metrics) == {"rmse", "mae", "irmse", "imae"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert comp.best_rmse == metrics["rmse"]
    best = tmp_path / cfg.model_name / "models" / "weights_best_completion"
    assert (best / ckpt.MODEL_FILE).exists()
    other = Completor(cfg, device="cpu")
    other.load(str(best))
    for k, v in comp.nets.state_dict().items():
        assert torch.equal(other.nets.state_dict()[k], v), k


def test_completor_refuses_microbatches(tmp_path):
    """The JAX completor takes whole-batch steps: no grad_accum_steps."""
    cfg = Config(completion_num_layers=18, weights_init="scratch",
                 log_dir=str(tmp_path), grad_accum_steps=2)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        Completor(cfg, device="cpu")


def test_completor_and_the_clis_need_a_card(monkeypatch, tmp_path):
    from fusiondepth_torch import completor, evaluate_completion, \
        export_detection

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(completion_num_layers=18, weights_init="scratch",
                 log_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA card"):
        Completor(cfg)
    argv = ["--completion_num_layers", "18", "--weights_init", "scratch",
            "--log_dir", str(tmp_path), "--data_path", str(tmp_path)]
    for cli in (completor, evaluate_completion, export_detection):
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main(argv)
    assert not os.listdir(tmp_path)


def test_gen2cha_completion_writes_the_jax_expansion(completion_tree,
                                                     monkeypatch):
    """The host-side CLI (numpy, no card) writes each frame's 2-channel
    cache as the JAX package's expansion of the bottom-cropped sparse
    depth, and skips existing caches unless told to regenerate. The port
    keeps only the numpy path of the expansion, so it is held to the JAX
    package's numpy path (its C++ fast path rounds some means 1 ulp
    apart)."""
    import fusiondepth_tpu.native
    from fusiondepth_torch import gen2cha_completion
    from fusiondepth_tpu.data.two_channel import expand_two_channel

    monkeypatch.setattr(fusiondepth_tpu.native, "expand_two_channel_native",
                        lambda *a: None)

    assert gen2cha_completion.main(["--data_path", completion_tree]) == 3
    assert gen2cha_completion.main(["--data_path", completion_tree]) == 0
    paths = cd.discover_paths(completion_tree, "train", verify=False)
    for p in paths["d"]:
        head, tail = os.path.split(p)
        got = np.load(os.path.join(os.path.dirname(head), "2cha",
                                   tail[:-4] + ".npy"))
        want = expand_two_channel(
            jax_cd.bottom_crop(jax_cd.load_depth_png(p)) / 100.0, expand=2,
            row_range=(110, 350), col_range=(2, 1214)).astype(np.float32)
        np.testing.assert_array_equal(got, want)


def test_evaluate_completion_cli_scores_and_exports_on_the_cpu(tmp_path):
    """The evaluate_completion CLI over the select val layout prints and
    returns finite metrics; with --completion_test it writes one 16-bit
    PNG (depth * 256) per anonymous test frame (R18, 352x1216, CPU)."""
    from fusiondepth_torch import evaluate_completion

    sel = tmp_path / "depth_selection"
    rng = np.random.default_rng(5)
    for split, dirs in (("val_selection_cropped",
                         ("image", "velodyne_raw", "groundtruth_depth")),
                        ("test_depth_completion_anonymous",
                         ("image", "velodyne_raw"))):
        for d in dirs:
            (sel / split / d).mkdir(parents=True)
            if d == "image":
                img = rng.uniform(0, 255, (352, 1216, 3)).astype(np.uint8)
            else:
                img = np.where(rng.uniform(size=(352, 1216)) < 0.05,
                               rng.uniform(2, 80, (352, 1216)) * 256,
                               0).astype(np.uint16)
            Image.fromarray(img).save(sel / split / d / "0000000000.png")
    argv = ["--completion_num_layers", "18", "--weights_init", "scratch",
            "--log_dir", str(tmp_path), "--data_path", str(tmp_path)]
    metrics = evaluate_completion.main(argv, device="cpu")
    assert set(metrics) == {"rmse", "mae", "irmse", "imae"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert evaluate_completion.main(argv + ["--completion_test"],
                                    device="cpu") is None
    out = tmp_path / "completion_test_export"
    assert sorted(os.listdir(out)) == ["0000000000.png"]
    png = np.array(Image.open(out / "0000000000.png"))
    assert png.dtype == np.uint16 and png.shape == (352, 1216)
    assert png.max() > 0
