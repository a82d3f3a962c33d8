"""The stage-1 training variants under the completor of the port
(training/completor.py) against the JAX package's
`make_completion_loss_fn`, on the setup of
tests/test_torch_port_completion.py (completion_num_layers and
completion_pose_num_layers 18, B=2, 64x96, float64, the weights carried by
models/jax_weights).

One whole step of the widest variant combination the JAX completor
traces: v1_multiscale (warps and SSIM at each scale's resolution) +
predictive_mask (with disable_automasking, so no noise is drawn) + the
shared pose type + pose_model_input="all" (the depth encoder over the
three frames in one pass, one pose decoder call over the three last
levels), without the beam encoders. Held at the bounds of
tests/test_torch_port_train.py: the loss to 1e-7 absolute, every gradient
leaf to rtol 1e-5 / atol 1e-9, the parameters after the completor's Adam
step to 1e-6 and the BN running statistics to 1e-9. The JAX side is one jitted function on the JAX
package's generic path (test_torch_port_models.GENERIC), the planes
box3's products kept in float64 (test_torch_port_ops._box3_f64).

Cheaper: one Completor.run_step on the CPU with each accepted variant,
and the refused use_stereo raising with its reason.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.ops import planes as jax_planes
from fusiondepth_tpu.training import completor as jax_completor
from fusiondepth_tpu.training.train_state import split_variables
from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import collate
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import NETS, from_jax_variables, \
    to_jax_variables
from fusiondepth_torch.training.completor import Completor, \
    completion_loss, make_completion_optimizer
from fusiondepth_torch.training.infer_driver import device_batch
from fusiondepth_torch.training.train_state import train_step
from fusiondepth_torch.training.trainer import TRAIN_KEYS

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jit, random_variables
from test_torch_port_ops import _box3_f64
from test_torch_port_train import assert_trees_close, make_inputs

B, H, W = 2, 64, 96
KW = dict(num_layers=18, completion_num_layers=18,
          completion_pose_num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch",
          v1_multiscale=True, predictive_mask=True, disable_automasking=True,
          pose_model_type="shared", pose_model_input="all",
          # the beam encoders are the default completion step's
          # (tests/test_torch_port_completion.py); without them the JAX
          # side compiles faster
          beam_encoder=False)
STEPS_PER_EPOCH = 10
CPU = torch.device("cpu")


def test_completion_variant_step_matches_jax_f64():
    batch = make_inputs()
    with jax.enable_x64():
        cfg = JaxConfig(**KW, pallas_warp=False, **GENERIC)
        nets = JaxFusionNets(cfg, pose_depth=cfg.completion_pose_num_layers)
        v = random_variables(lambda: nets.init(jax.random.PRNGKey(0),
                                               batch_size=B),
                             np.random.default_rng(0), np.float64)
        params, stats = split_variables(v)
        loss_f = jax_completor.make_completion_loss_fn(cfg, nets)
        tx = jax_completor.make_completion_optimizer(cfg, STEPS_PER_EPOCH)

        def run(params, stats, batch, key):
            (loss, (losses, new_stats)), grads = jax.value_and_grad(
                loss_f, has_aux=True)(params, stats, batch, key)
            updates, _ = tx.update(grads, tx.init(params), params)
            return loss, losses, grads, new_stats, optax.apply_updates(
                params, updates)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_planes, "box3", _box3_f64)
            out = jit(run)(params, stats, {k: jnp.asarray(x)
                                           for k, x in batch.items()},
                           jax.random.PRNGKey(42))
        loss, losses, grads, new_stats, new_params = jax.tree.map(
            np.asarray, out)

    port_cfg = Config(**KW)
    ours = FusionNets(port_cfg, device=CPU, pose_depth=18)
    assert ours.pose_encoder is None and ours.pose.squeeze.in_channels == \
        512
    ours.load_state_dict(from_jax_variables({k: v[k] for k in NETS
                                             if k in v}))
    opt, sched = make_completion_optimizer(port_cfg, ours, STEPS_PER_EPOCH)
    got = train_step(port_cfg, ours, opt, sched,
                     device_batch(batch, CPU, TRAIN_KEYS, torch.float64),
                     loss_of=completion_loss)
    assert abs(float(got["loss"]) - float(loss)) < 1e-7, (
        float(got["loss"]), float(loss))
    assert set(got) == set(losses)
    assert abs(float(got["loss/si_loss0"]) - float(losses["loss/si_loss0"])
               ) < 1e-7
    g = {n: p.grad for n, p in ours.named_parameters()}
    assert all(v is not None for v in g.values())
    assert_trees_close({k: v["params"]
                        for k, v in to_jax_variables(g).items()},
                       grads, rtol=1e-5, atol=1e-9)
    after = to_jax_variables(ours.state_dict())
    assert_trees_close({k: v["params"] for k, v in after.items()},
                       new_params, rtol=0, atol=1e-6)
    assert_trees_close({k: v["batch_stats"] for k, v in after.items()
                        if "batch_stats" in v},
                       {k: s for k, s in new_stats.items() if s},
                       rtol=0, atol=1e-9)


@pytest.mark.parametrize("flag", [
    dict(v1_multiscale=True),
    dict(predictive_mask=True, disable_automasking=True),
    dict(pose_model_type="posecnn"), dict(pose_model_type="shared"),
    dict(pose_model_input="all")])
def test_completor_steps_with_each_accepted_variant(flag, tmp_path):
    """One Completor.run_step at completion_not_full_res (192x640), R18,
    batch 1, without the beam encoders: a finite loss with its SI term,
    and the depth decoder and the pose net moved."""
    cfg = Config(completion_not_full_res=True, completion_num_layers=18,
                 completion_pose_num_layers=18, batch_size=1,
                 weights_init="scratch", log_dir=str(tmp_path),
                 height=192, width=640, beam_encoder=False, **flag)
    comp = Completor(cfg, device="cpu")
    before = {k: v.clone() for k, v in comp.nets.state_dict().items()}
    losses = comp.run_step(collate([SyntheticDataset(cfg, length=1)[0]]))
    assert np.isfinite(float(losses["loss"])) and "loss/si_loss0" in losses
    moved = {k.split(".")[0] for k, v in comp.nets.state_dict().items()
             if not torch.equal(v, before[k])}
    assert {"depth", "pose"} <= moved


def test_completor_refuses_stereo_with_its_reason(tmp_path):
    cfg = Config(completion_num_layers=18, weights_init="scratch",
                 log_dir=str(tmp_path), use_stereo=True)
    with pytest.raises(NotImplementedError, match="integer offset"):
        Completor(cfg, device="cpu")
