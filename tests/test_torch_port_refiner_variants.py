"""The stage-1 training variants under the refiner of the port
(fusiondepth_torch/training/refiner.py, refiner_driver.py) against the
JAX package, on the setup of tests/test_torch_port_refiner.py: ResNet-18
stage-1 nets and the road + catxy + deep refine2d decoder at B=2, 64x96,
float64 on both sides, the weights carried by models/jax_weights.

One whole step of the widest stage-1 variant combination the JAX refiner
traces: the posecnn pose net + use_stereo with the frame "s" (warped by
stereo_T) + predictive_mask (which there only turns the automask off:
the refine loss reads no mask), with train_entire_net so that the
gradient reaches PoseCNN. The JAX side is the JAX Refiner's
`entire_loss` (fusiondepth_tpu/training/refiner_driver.py:66-75) under
jax.value_and_grad, one jitted function on the JAX package's generic path
(test_torch_port_models.GENERIC), the planes box3's products kept in
float64 (test_torch_port_ops._box3_f64). Bounds (PERF.md §2): the loss to
1e-7 absolute, every gradient leaf, the stage-1 leaves included, to
rtol 1e-5 / atol 1e-9.

Cheaper: one Refiner.run_step on the CPU with each option the refiner
accepts now, and its refusals (v1_multiscale and the shared pose type,
which the JAX refiner cannot trace) raising with their reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.ops import planes as jax_planes
from fusiondepth_tpu.training.refiner import RefinerNets as JaxRefinerNets
from fusiondepth_tpu.training.refiner import make_refine_loss_fn
from fusiondepth_torch.config import Config
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.models.jax_weights import NETS
from fusiondepth_torch.training.infer_driver import device_batch
from fusiondepth_torch.training.refiner import REFINE_KEYS, RefinerNets, \
    refine_loss
from fusiondepth_torch.training.refiner_driver import Refiner

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jax_sides_in_threads, jit, \
    random_variables
from test_torch_port_ops import _box3_f64
from test_torch_port_refiner import entire_grads, load_jax
from test_torch_port_train import assert_trees_close
from test_torch_port_variants import stereo_inputs

B, H, W = 2, 64, 96
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch",
          train_entire_net=True, clone_gdc=True, refine_2d=True)
VARIANTS = dict(pose_model_type="posecnn", use_stereo=True,
                frame_ids=(0, -1, 1, "s"), predictive_mask=True,
                disable_automasking=True)
CPU = torch.device("cpu")


def jax_variant_step():
    """The JAX refiner's entire_loss of the module's variant combination
    under jax.value_and_grad, float64: (its inputs, loss, terms and
    gradients)."""
    kw = {**KW, **VARIANTS}
    batch = stereo_inputs()
    batch["inf_gdc"] = np.random.default_rng(2).uniform(0.5, 1.5,
                                                         (B, H, W, 1))
    with jax.enable_x64():
        cfg = JaxConfig(**kw, pallas_warp=False, **GENERIC)
        nets = JaxRefinerNets(cfg)
        rng = np.random.default_rng(0)
        frozen = random_variables(
            lambda: nets.stage1.init(jax.random.PRNGKey(0), batch_size=B),
            rng, np.float64)
        refine_params = random_variables(
            lambda: nets.init_refine(jax.random.PRNGKey(3), batch_size=B),
            rng, np.float64)
        stats = {k: v.get("batch_stats", {}) for k, v in frozen.items()}
        loss_fn = make_refine_loss_fn(cfg, nets)

        def entire_loss(trainable, batch, key):
            fixed = {}
            for k, p in trainable["stage1"].items():
                fixed[k] = {"params": p}
                if stats[k]:
                    fixed[k]["batch_stats"] = stats[k]
            return loss_fn(trainable["refine"], fixed, batch, key)

        trainable = {"refine": refine_params,
                     "stage1": {k: v["params"] for k, v in frozen.items()}}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_planes, "box3", _box3_f64)
            out = jit(jax.value_and_grad(entire_loss, has_aux=True))(
                trainable, {k: jnp.asarray(x) for k, x in batch.items()},
                jax.random.PRNGKey(42))
        (loss, losses), grads = jax.tree.map(np.asarray, out)
    return kw, batch, frozen, refine_params, loss, losses, grads


@pytest.fixture(scope="module", autouse=True)
def jax_step():
    """`jax_variant_step` under way in a thread from the module's first
    test on (XLA's compile releases the GIL; under pytest-xdist from the
    test that reads it: `JaxSides`): the Refiner steps run meanwhile, and
    the test that reads it comes last."""
    with jax_sides_in_threads(
            step=lambda sides: jax_variant_step()) as sides:
        yield sides["step"]


@pytest.mark.parametrize("flag", [
    dict(pose_model_type="posecnn"), dict(pose_model_input="all"),
    dict(use_stereo=True),
    dict(predictive_mask=True, disable_automasking=True),
    dict(train_entire_net=True)])
def test_refiner_steps_with_each_accepted_option(flag, tmp_path):
    """One Refiner.run_step on the CPU with each option the port now
    accepts, without the beam encoders to keep it cheap: a finite loss;
    the stage-1 nets move only under train_entire_net, and then save and
    load into a new Refiner carry them, the refine decoder and the Adam
    state. use_stereo adds no frame here (the JAX refiner does not add
    "s", unlike the trainer)."""
    cfg = Config(num_layers=18, height=H, width=W, batch_size=B,
                 weights_init="scratch", log_dir=str(tmp_path),
                 beam_encoder=False, **flag)
    refiner = Refiner(cfg, device="cpu")
    assert refiner.cfg.frame_ids == (0, -1, 1)
    data = SyntheticDataset(cfg, length=B)
    batch = {k: np.stack([data[i][k] for i in range(B)]) for k in data[0]}
    batch["inf_gdc"] = np.full((B, H, W, 1), 10.0, np.float32)
    s1 = {k: v.clone() for k, v in refiner.nets.stage1.state_dict().items()}
    losses = refiner.run_step(batch)
    assert np.isfinite(float(losses["loss"]))
    moved = {k for k, v in refiner.nets.stage1.state_dict().items()
             if not torch.equal(v, s1[k])}
    if not cfg.train_entire_net:
        assert not moved
        return
    assert any(k.startswith("encoder.") for k in moved)
    assert not any("running_" in k for k in moved)
    reloaded = Refiner(cfg, device="cpu")
    reloaded.load(refiner.save("entire"))
    assert reloaded.step == 1
    want = refiner.nets.state_dict()
    for k, v in reloaded.nets.state_dict().items():
        assert torch.equal(v, want[k]), k
    o1 = refiner.optimizer.state_dict()["state"]
    o2 = reloaded.optimizer.state_dict()["state"]
    assert len(o1) == len(o2) == sum(
        p.grad is not None for p in refiner.nets.parameters())
    assert all(torch.equal(o1[i]["exp_avg"], o2[i]["exp_avg"]) for i in o1)


@pytest.mark.parametrize("flag,reason", [
    (dict(v1_multiscale=True), "warped_planes"),
    (dict(pose_model_type="shared"), "one pyramid per frame")])
def test_refiner_refused_options_raise_with_their_reason(flag, reason,
                                                         tmp_path):
    cfg = Config(num_layers=18, height=H, width=W, batch_size=B,
                 weights_init="scratch", log_dir=str(tmp_path), **flag)
    with pytest.raises(NotImplementedError, match=reason):
        Refiner(cfg, device="cpu")


def test_refiner_variant_step_matches_jax_f64(jax_step):
    """The widest stage-1 variant combination the JAX refiner traces,
    with train_entire_net: posecnn + use_stereo (frame "s", warped by
    stereo_T) + predictive_mask (no automask, so no noise is drawn): the
    loss, its terms and every gradient leaf, PoseCNN's included. The mask
    decoder, the beam-pose encoder and the depth decoder's heads at scales
    1-3 are unread: 0 in JAX, None in the port."""
    kw, batch, frozen, refine_params, loss, losses, grads = jax_step.result()
    ours = RefinerNets(Config(**kw), device=CPU)
    load_jax(ours, {"frozen": {k: frozen[k] for k in NETS if k in frozen},
                    "refine_params": refine_params})
    got, got_losses = refine_loss(
        ours.cfg, ours, device_batch(batch, CPU, REFINE_KEYS, torch.float64))
    assert abs(got.item() - float(loss)) < 1e-7, (got.item(), float(loss))
    assert set(got_losses) == set(losses)
    got.backward()
    unread = {n for n, p in ours.stage1.named_parameters() if p.grad is None}
    assert {n.split(".")[0] for n in unread} == {
        "predictive_mask", "beam_encoder_pose", "depth"}
    assert all(n.startswith("depth.dispconv_") for n in unread
               if n.startswith("depth."))
    assert ours.stage1.pose.pose_conv.weight.grad.abs().max() > 0
    assert_trees_close(entire_grads(ours), grads, rtol=1e-5, atol=1e-9)
