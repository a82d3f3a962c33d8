"""remat in the port: the training-mode forward as one non-reentrant
torch.utils.checkpoint region (training/train_state.py::train_forward),
the region the JAX package wraps in jax.checkpoint.

A step with remat must be the step without it: the loss, every gradient
leaf and the BN running statistics within 1e-12 in float64 (recomputing
the same forward on the CPU gives the same bits), for the stage-1 train
step and for the completion step. The step without remat is held against
the JAX package by tests/test_torch_port_train.py and
tests/test_torch_port_completion.py, and the JAX package's remat against
its plain step by tests/test_remat.py, so no JAX trace is needed here.
The forward must also run twice (once more in the backward), or remat
would be a no-op, and the BN running statistics must move once.
"""

import numpy as np
import pytest
import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.training.completor import completion_loss
from fusiondepth_torch.training.infer_driver import device_batch
from fusiondepth_torch.training.train_state import loss_fn
from fusiondepth_torch.training.trainer import TRAIN_KEYS

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_train import make_inputs

B, H, W = 2, 64, 96
# without the beam encoders, to keep the four steps cheap
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch",
          beam_encoder=False)
CPU = torch.device("cpu")


def one_step(cfg, loss_of):
    """(loss, {param: grad}, {buffer: value}, encoder forwards) of one
    training-mode step of `loss_of` on seeded nets, no update."""
    nets = FusionNets(cfg, device=CPU,
                      generator=torch.Generator().manual_seed(4),
                      pose_depth=18)
    calls = []
    nets.encoder.register_forward_hook(lambda *a: calls.append(1))
    batch = device_batch(make_inputs(), CPU, TRAIN_KEYS, torch.float64)
    g = torch.Generator().manual_seed(5)
    noise = [torch.randn((2, B, H, W), generator=g, dtype=torch.float64)
             * 1e-5 for _ in cfg.scales]
    loss, _ = loss_of(cfg, nets, batch, noise=noise)
    loss.backward()
    return (loss.item(), {n: p.grad for n, p in nets.named_parameters()},
            {n: b.clone() for n, b in nets.named_buffers()}, len(calls))


@pytest.mark.parametrize("step", ["train", "completion"])
def test_remat_step_equals_the_step_without(step):
    cfg = Config(**KW)
    loss_of = loss_fn if step == "train" else completion_loss
    plain = one_step(cfg, loss_of)
    remat = one_step(cfg.replace(remat=True), loss_of)
    fresh = FusionNets(cfg, device=CPU,
                       generator=torch.Generator().manual_seed(4),
                       pose_depth=18)
    assert plain[3] == 1 and remat[3] == 2, (plain[3], remat[3])
    assert abs(remat[0] - plain[0]) <= 1e-12
    assert remat[1].keys() == plain[1].keys()
    for n, g in plain[1].items():
        assert g is not None, n
        np.testing.assert_allclose(remat[1][n].numpy(), g.numpy(),
                                   rtol=0, atol=1e-12, err_msg=n)
    moved = 0
    for n, b in plain[2].items():
        np.testing.assert_allclose(remat[2][n].numpy(), b.numpy(), rtol=0,
                                   atol=1e-12, err_msg=n)
        moved += not torch.equal(b, fresh.state_dict()[n])
    assert moved > 0
