"""The stage-1 train step of the port (fusiondepth_torch) against the JAX
package, on the setup of tests/test_train_step_torch_parity.py: four
ResNet-18 encoders, the depth decoder with beam fusion and the pose
decoder at B=2, 64x96, in float64 on both sides, with the same weights
(carried by models/jax_weights) and the same automask noise (the JAX
draws replayed through `noise=`).

Held against the JAX side:
- FusionNets.forward(train=True): disparities and poses to 1e-9, and the
  BN running statistics it updates in place;
- the loss of make_loss_fn to 1e-7 absolute and every gradient leaf to
  rtol 1e-5, atol 1e-9 (the bound of the torch-oracle test). The two sides
  differ by summation order and by the JAX box3, which rounds its banded
  products to float32 even under x64 (tests/test_torch_port_ops.py), so
  1e-9 on the loss is not reached: the difference measured here is
  5.5e-9 on a loss of 0.41;
- the parameters after one step of the port's train_step against the
  update of JAX make_train_step (with grad_accum_steps 1 it is the JAX
  optimizer's tx.update and optax.apply_updates on make_loss_fn's
  gradients, applied here to those gradients so that the loss is traced
  once), to atol 1e-6: an Adam step moves a
  parameter by lr * g / (|g| + 1e-8), lr = 2.5e-5, so where a gradient
  leaf is near 0 its 1e-9 agreement allows up to 2.5e-6 of difference in
  the step (1.2e-7 is measured here); the BN statistics to 1e-9.

The JAX side is one jitted function, computed once per module, on the
JAX package's generic path (its TPU layout flags off,
test_torch_port_models.GENERIC).
"""

import copy
import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.training.train_state import (
    make_loss_fn,
    make_optimizer as jax_make_optimizer,
    split_variables,
)
from fusiondepth_torch.config import Config
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import (
    NETS,
    from_jax_variables,
    to_jax_variables,
)
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.eval_driver import predict_disparities
from fusiondepth_torch.training.infer_driver import Infer, device_batch
from fusiondepth_torch.training.train_state import (
    loss_fn,
    make_optimizer,
    train_step,
)
from fusiondepth_torch.training.trainer import TRAIN_KEYS, Trainer

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jit, random_variables

B, H, W = 2, 64, 96
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch")
STEPS_PER_EPOCH = 10
CPU = torch.device("cpu")
SRC = (-1, 1)
POSE_KEYS = [(k, 0, f) for f in SRC
             for k in ("axisangle", "translation", "cam_T_cam")]


def make_inputs(seed=7):
    """The batch of tests/test_train_step_torch_parity.py (another one of
    the same kind from another seed)."""
    rng = np.random.default_rng(seed)
    F_ = 3
    color = rng.uniform(0, 1, (B, F_, H, W, 3))
    color_aug = np.clip(color + rng.normal(0, 0.02, color.shape), 0, 1)
    two_ch = np.zeros((B, F_, H, W, 2))
    hit = rng.uniform(size=(B, F_, H, W)) < 0.15
    d = rng.uniform(2.0, 20.0, (B, F_, H, W))
    two_ch[..., 0] = np.where(hit, d / 100.0, 0.0)
    two_ch[..., 1] = np.where(hit, 1.0 / (d + 1.0), 0.0)
    four_beam = np.where(rng.uniform(size=(B, H, W, 1)) < 0.1,
                         rng.uniform(3.0, 7.0, (B, H, W, 1)) / 100.0, 0.0)
    K = np.zeros((B, 4, 4))
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    return {"color": color, "color_aug": color_aug, "two_channel": two_ch,
            "four_beam": four_beam, "K": K, "inv_K": np.linalg.inv(K)}


@functools.cache
def jax_train_inputs():
    """The inputs of jax_train_side's step, made without compiling it: the
    config, nets, float64 variables, batch, key and the automask noise of
    photometric.py's scale loop drawn from the key."""
    batch = make_inputs()
    with jax.enable_x64():
        cfg = JaxConfig(**KW, pallas_warp=False, **GENERIC)
        nets = JaxFusionNets(cfg)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0),
                                               batch_size=B),
                             np.random.default_rng(0), np.float64)
        key = jax.random.PRNGKey(42)
        noise, r = [], key
        for _ in cfg.scales:
            r, sub = jax.random.split(r)
            noise.append(torch.from_numpy(np.asarray(jax.random.normal(
                sub, (len(SRC), B, H, W))) * 1e-5))
    return dict(cfg=cfg, nets=nets, v=v, batch=batch, key=key, noise=noise,
                variables={k: v[k] for k in NETS if k in v})


@functools.cache
def jax_train_side():
    """The JAX side of this module's checks, computed once per process:
    tests/test_torch_port_parallel.py holds its data-parallel step against
    the same step."""
    inputs = jax_train_inputs()
    cfg, nets, v, batch, key = (inputs[k] for k in ("cfg", "nets", "v",
                                                     "batch", "key"))
    with jax.enable_x64():
        params, stats = split_variables(v)
        loss_f = make_loss_fn(cfg, nets)
        tx = jax_make_optimizer(cfg, STEPS_PER_EPOCH)

        # the training-mode forward that make_loss_fn runs, read out of
        # the loss's own trace (one compile of one forward)
        forward, seen = nets.forward, {}

        def recording_forward(*args, **kwargs):
            seen["out"], updates = forward(*args, **kwargs)
            return seen["out"], updates

        def loss_and_forward(params, stats, batch, key):
            nets.forward = recording_forward
            try:
                loss, aux = loss_f(params, stats, batch, key)
            finally:
                del nets.forward
            out = seen.pop("out")
            fwd = [out[("disp", s)] for s in cfg.scales]
            return loss, (aux, fwd + [out[k] for k in POSE_KEYS])

        def run(params, stats, batch, key):
            (loss, ((losses, new_stats), fwd)), grads = jax.value_and_grad(
                loss_and_forward, has_aux=True)(params, stats, batch, key)
            # make_train_step's update (grad_accum_steps 1) from these
            # gradients, without tracing the loss a second time
            updates, _ = tx.update(grads, tx.init(params), params)
            return fwd, loss, grads, new_stats, optax.apply_updates(
                params, updates)

        run = jit(run)
        out = run(params, stats,
                  {k: jnp.asarray(x) for k, x in batch.items()}, key)
        fwd, loss, grads, new_stats, new_params = jax.tree.map(np.asarray,
                                                               out)
    # the compiled step (under jax.enable_x64) and its parts, for a step of
    # the same shapes on other inputs
    return dict(variables=inputs["variables"], batch=batch, fwd=fwd,
                loss=float(loss), grads=grads, new_stats=new_stats,
                new_params=new_params, noise=inputs["noise"], run=run,
                cfg=cfg, tx=tx)


@pytest.fixture(scope="module")
def jax_side():
    return jax_train_side()


def port_nets(jax_side):
    nets = FusionNets(Config(**KW), device=CPU)
    nets.load_state_dict(from_jax_variables(jax_side["variables"]))
    return nets


def port_batch(jax_side):
    return device_batch(jax_side["batch"], CPU, TRAIN_KEYS, torch.float64)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(map(str, path)), np.asarray(tree)


def assert_trees_close(got, want, rtol, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    bad = []
    for k in want:
        err = np.abs(got[k] - want[k]) - (atol + rtol * np.abs(want[k]))
        if got[k].shape != want[k].shape or err.max() > 0:
            bad.append(f"{k}: max|d|={np.abs(got[k] - want[k]).max():.3e} "
                       f"scale={np.abs(want[k]).max():.3e}")
    assert not bad, "\n".join(bad)


def test_forward_train_matches_jax_f64(jax_side):
    """Disparities, poses and the BN running statistics after one
    training-mode forward (pose pairs stacked on the batch axis)."""
    nets = port_nets(jax_side)
    out = nets(port_batch(jax_side), train=True)
    got = [out[("disp", s)] for s in range(4)] + [out[k] for k in POSE_KEYS]
    for g, w, name in zip(got, jax_side["fwd"],
                          [f"disp {s}" for s in range(4)] + POSE_KEYS):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-9, rtol=0,
                                   err_msg=str(name))
    stats = {k: v["batch_stats"]
             for k, v in to_jax_variables(nets.state_dict()).items()
             if "batch_stats" in v}
    assert_trees_close(stats, {k: v for k, v in jax_side["new_stats"].items()
                               if v}, rtol=0, atol=1e-9)


def test_loss_grads_and_one_adam_step_match_jax_f64(jax_side):
    """One train_step of the port: its loss and every gradient leaf
    against make_loss_fn's, then the parameters and BN statistics after
    the Adam update against make_train_step's update."""
    nets = port_nets(jax_side)
    cfg = nets.cfg
    opt, sched = make_optimizer(cfg, nets, STEPS_PER_EPOCH)
    losses = train_step(cfg, nets, opt, sched, port_batch(jax_side),
                        noise=jax_side["noise"])
    assert abs(float(losses["loss"]) - jax_side["loss"]) < 1e-7, (
        float(losses["loss"]), jax_side["loss"])
    grads = {n: p.grad for n, p in nets.named_parameters()}
    assert all(g is not None for g in grads.values())
    assert_trees_close({k: v["params"]
                        for k, v in to_jax_variables(grads).items()},
                       jax_side["grads"], rtol=1e-5, atol=1e-9)
    got = to_jax_variables(nets.state_dict())
    assert_trees_close({k: v["params"] for k, v in got.items()},
                       jax_side["new_params"], rtol=0, atol=1e-6)
    assert_trees_close({k: v["batch_stats"] for k, v in got.items()
                        if "batch_stats" in v},
                       {k: v for k, v in jax_side["new_stats"].items() if v},
                       rtol=0, atol=1e-9)


def test_lr_schedule_steps_like_optax():
    """lr * batch / 8, then x0.1 at each of three boundaries."""
    cfg = Config(**KW)
    nets = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(cfg, nets, steps_per_epoch=1)
    boundary = int(cfg.scheduler_step_size * 8 / B)
    lrs = []
    for _ in range(4 * boundary + 2):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    base = cfg.learning_rate * B / 8
    want = [base * 0.1 ** min(i // boundary, 3) for i in range(len(lrs))]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)


def test_trainer_steps_checkpoint_and_infer_round_trip(tmp_path):
    """Two steps of Trainer.run_epoch on synthetic frames, a checkpoint
    with the optimizer state, a resume that restores it, and the bundle
    reloaded by Infer giving the same disparities (without the beam
    encoders, to keep the files small)."""
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1, log_frequency=1, beam_encoder=False)
    data = SyntheticDataset(cfg, length=4, seed=1)
    trainer = Trainer(cfg, train_dataset=data, device="cpu")
    before = {k: v.clone() for k, v in trainer.nets.state_dict().items()}
    losses = trainer.run_epoch()
    assert len(losses) == 2 and trainer.step == 2
    assert all(np.isfinite(float(x)) for x in losses)
    moved = [k for k, v in trainer.nets.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.startswith("pose.") for k in moved)
    assert any("running_mean" in k for k in moved)
    path = trainer.save("t")

    resumed = Trainer(cfg.replace(train_load_weights_folder=path,
                                  models_to_load=("encoder", "depth",
                                                  "pose_encoder", "pose")),
                      train_dataset=data, device="cpu")
    assert resumed.step == 2
    for k, v in trainer.nets.state_dict().items():
        assert torch.equal(resumed.nets.state_dict()[k], v), k
    o1, o2 = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert o1["param_groups"][0]["lr"] == o2["param_groups"][0]["lr"]
    for i, s in o1["state"].items():
        assert torch.equal(s["exp_avg_sq"], o2["state"][i]["exp_avg_sq"])
    assert resumed.scheduler.last_epoch == trainer.scheduler.last_epoch

    infer = Infer(cfg.replace(load_weights_folder=path), device="cpu")
    batch = device_batch({k: np.stack([data[i][k] for i in range(2)])
                          for k in ("color_aug", "two_channel",
                                    "four_beam")}, CPU)
    with torch.no_grad():
        want = trainer.nets.forward_depth(batch, train=False)[0][("disp", 0)]
    assert torch.equal(infer.infer(batch), want)


@pytest.mark.parametrize("case", ["world_of_one_trains",
                                  "mesh_of_two_in_one_process_raises"])
def test_use_mesh_in_one_process(case, tmp_path):
    """use_mesh=True in a world of one trains a step with no collective
    (the mesh's group is None); mesh_shape=(2,) in one process raises the
    ValueError that says to launch two processes with torchrun."""
    mesh_shape = (1,) if case == "world_of_one_trains" else (2,)
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1, use_mesh=True, mesh_shape=mesh_shape)
    data = SyntheticDataset(cfg, length=2)
    if case != "world_of_one_trains":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            Trainer(cfg, train_dataset=data, device="cpu")
        return
    trainer = Trainer(cfg, train_dataset=data, device="cpu")
    assert trainer.mesh.shape == {"data": 1} and trainer.group is None
    losses = trainer.run_epoch()
    assert len(losses) == 1 and np.isfinite(float(losses[0]))


@pytest.mark.parametrize("driver", ["Refiner", "Completor"])
def test_bf16_still_refused_by_refiner_and_completor(driver, tmp_path):
    """compute_dtype="bfloat16" runs stage-1 serving and the default
    stage-1 train step; the refiner and the completor still refuse it,
    naming the ROADMAP item, before they build anything."""
    from fusiondepth_torch.training.completor import Completor
    from fusiondepth_torch.training.refiner_driver import Refiner

    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 compute_dtype="bfloat16")
    cls = {"Refiner": Refiner, "Completor": Completor}[driver]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cls(cfg, device="cpu")


@pytest.mark.parametrize("flag", [
    dict(v1_multiscale=True), dict(use_stereo=True),
    dict(predictive_mask=True, disable_automasking=True),
    dict(pose_model_type="posecnn"), dict(pose_model_type="shared"),
    dict(pose_model_input="all"), dict(remat=True)])
def test_bf16_training_variants_raise(flag, tmp_path):
    """Under bfloat16 the Trainer takes the default step only: each
    training variant and remat raise NotImplementedError, naming the
    option and the ROADMAP item."""
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 compute_dtype="bfloat16", **flag)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, train_dataset=SyntheticDataset(cfg, length=2),
                device="cpu")


@pytest.mark.parametrize("flag", [
    dict(v1_multiscale=True),
    dict(use_stereo=True),
    dict(predictive_mask=True, disable_automasking=True),
    dict(pose_model_type="posecnn"),
    dict(pose_model_type="shared"),
    dict(pose_model_input="all")])
def test_trainer_steps_with_each_training_variant(flag, tmp_path):
    """One Trainer step on the CPU with each stage-1 training variant
    (each is held against the JAX package in
    tests/test_torch_port_variants.py), without the beam encoders to keep
    it cheap: a finite loss, and the pose net and the depth decoder moved.
    use_stereo adds the frame "s", whose samples carry stereo_T (the
    dataset is made with it)."""
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1, log_frequency=1, beam_encoder=False, **flag)
    data_cfg = cfg.replace(frame_ids=(0, -1, 1, "s")) if cfg.use_stereo \
        else cfg
    trainer = Trainer(cfg, train_dataset=SyntheticDataset(data_cfg,
                                                          length=2),
                      device="cpu")
    assert trainer.cfg.frame_ids == data_cfg.frame_ids
    before = {k: v.clone() for k, v in trainer.nets.state_dict().items()}
    losses = trainer.run_epoch()
    assert len(losses) == 1 and np.isfinite(float(losses[0]))
    moved = {k.split(".")[0] for k, v in trainer.nets.state_dict().items()
             if not torch.equal(v, before[k])}
    assert {"pose", "depth", "encoder"} <= moved


def test_all_pose_inputs_with_the_stereo_frame_raise(tmp_path):
    """pose_model_input="all" with use_stereo: the stereo frame would count
    as a pose input at init and never reach the pose nets, which the JAX
    package cannot init either."""
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 use_stereo=True, pose_model_input="all")
    with pytest.raises(ValueError, match="'all'"):
        Trainer(cfg, train_dataset=SyntheticDataset(cfg, length=2),
                device="cpu")


def test_pallas_reproj_trains_through_the_plain_version_on_the_cpu():
    """The loss takes the fused reprojection-loss op with pallas_reproj
    off or on (the flag is the JAX package's, accepted for parity), and
    the op's wrapper takes its plain version for CPU tensors: both
    settings call the wrapper, forward and backward, give the same loss
    and gradients, and launch no kernel."""
    from fusiondepth_torch.kernels import LAUNCHES, reset_launches
    from fusiondepth_torch.kernels import reproj as reproj_kernel

    cfg = Config(**{**KW, "compute_dtype": "float32"})
    batch = device_batch(make_inputs(), CPU, TRAIN_KEYS, torch.float32)
    noise = [torch.zeros(len(SRC), B, H, W) for _ in range(4)]
    results = []
    for fused in (False, True):
        nets = FusionNets(cfg.replace(pallas_reproj=fused), device=CPU)
        reset_launches()
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for attr in ("reproj_fwd", "reproj_bwd"):
                def counted(*a, _f=getattr(reproj_kernel, attr), _n=attr):
                    calls.append(_n)
                    return _f(*a)
                mp.setattr(reproj_kernel, attr, counted)
            loss, _ = loss_fn(nets.cfg, nets, batch, noise=noise)
            loss.backward()
        assert sorted(calls) == ["reproj_bwd", "reproj_fwd", "reproj_fwd"]
        assert not any(LAUNCHES.values())
        results.append((loss.item(), [p.grad for p in nets.parameters()]))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path))
    data = SyntheticDataset(cfg, length=2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Trainer(cfg, train_dataset=data)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Infer(cfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        predict_disparities(cfg, data)
    assert not os.path.exists(tmp_path / cfg.model_name / "models" /
                              "weights_0")
    assert Infer(cfg, device="cpu").device == CPU


def test_grad_accum_averages_microbatch_grads_and_carries_bn_stats():
    """grad_accum_steps=2: the gradient the optimizer sees is the mean of
    the two microbatches' gradients, and the BN running statistics go
    through both microbatches in turn (as the JAX package's lax.scan
    carries them). No automask, so no noise is drawn."""
    cfg = Config(**{**KW, "compute_dtype": "float32"}, grad_accum_steps=2,
                 disable_automasking=True)
    nets = FusionNets(cfg, device=CPU)
    ref = copy.deepcopy(nets)
    batch = device_batch(make_inputs(), CPU, TRAIN_KEYS, torch.float32)
    opt, sched = make_optimizer(cfg, nets, STEPS_PER_EPOCH)
    losses = train_step(cfg, nets, opt, sched, batch)
    mean_loss = 0.0
    grads = {n: torch.zeros_like(p) for n, p in ref.named_parameters()}
    for i in range(2):
        ref.zero_grad(set_to_none=True)
        loss, _ = loss_fn(cfg, ref, {k: v[i:i + 1] for k, v in batch.items()})
        loss.backward()
        mean_loss += loss.item() / 2
        for n, p in ref.named_parameters():
            grads[n] += p.grad / 2
    assert abs(float(losses["loss"]) - mean_loss) < 1e-6
    for n, p in nets.named_parameters():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-5, atol=1e-9)
    for n, b in nets.named_buffers():
        torch.testing.assert_close(b, dict(ref.named_buffers())[n],
                                   rtol=1e-6, atol=1e-7)


class FramesWithGT:
    """Synthetic frames with a ground-truth depth map each (eval split)."""

    def __init__(self, cfg, n):
        self.inner = SyntheticDataset(cfg, length=n, seed=4)
        rng = np.random.default_rng(4)
        self.gt = [rng.uniform(2.0, 60.0, (cfg.height, cfg.width))
                   .astype(np.float32) for _ in range(n)]

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return {**self.inner[i], "depth_gt": self.gt[i]}


def test_trainer_validate_scores_and_keeps_the_best(tmp_path):
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1)
    trainer = Trainer(cfg, train_dataset=SyntheticDataset(cfg, length=2),
                      val_dataset=FramesWithGT(cfg, 2), device="cpu")
    metrics = trainer.validate()
    assert set(metrics) >= {"abs_rel", "sq_rel", "rmse", "a1"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert trainer.best_absrel == metrics["abs_rel"]
    best = tmp_path / cfg.model_name / "models" / "weights_best"
    assert (best / ckpt.MODEL_FILE).exists()
    assert (best / ckpt.OPTIMIZER_FILE).exists()


def test_trainer_cli_needs_a_card(monkeypatch, tmp_path):
    from fusiondepth_torch import trainer as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(["--num_layers", "18", "--height", "64", "--width", "96",
                  "--weights_init", "scratch", "--log_dir", str(tmp_path)])
