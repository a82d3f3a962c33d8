"""Data parallelism of the port (fusiondepth_torch/parallel/, the
Trainer's use_mesh, fusiondepth_torch/multichip.py) against the JAX
package on the CPU.

The JAX meshed step computes the global batch's step: GSPMD takes every
batch-axis mean over the whole batch, BatchNorm statistics and the SI
loss included. So a world of W ranks of the port is held against the JAX
step on one device:
- shard_lines and local_batch_size equal the JAX functions on the cases
  of tests/test_multihost.py;
- a gloo world of 2 ranks, one row each of test_torch_port_train.py's
  batch (its jax_side: B=2, 64x96, ResNet-18, float64, the same weights
  and noise), against that module's JAX step: the loss, every gradient
  leaf after the all-reduce, the BN running statistics and the
  parameters after one Adam step, at that module's tolerances (loss 1e-7
  absolute, gradients rtol 1e-5 / atol 1e-9, parameters 1e-6, statistics
  1e-9). The two rows have their own SI valid counts and BN statistics:
  the same world's loss with per-rank BN statistics, and with a per-rank
  SI loss, misses its tolerance;
- the same world with grad_accum_steps=2 at global batch 4 against the
  JAX make_train_step's microbatch loop with grad_accum_steps=2, run with
  jax_side's compiled loss and gradient (`jax_accum_side`): the loss, the
  parameters after Adam and the BN statistics carried through both
  microbatches (the microbatch membership: rank r holds the r-th half of
  each global microbatch);
- one float32 step of the JAX Trainer(use_mesh=True, mesh_shape=(2,)) on
  two of conftest's eight CPU devices (ResNet-18, 64x64, batch 2) against
  the port's two-rank Trainer on the same weights (models/jax_weights.py),
  batch and noise: the loss within chip_smoke.py's float32 step bound
  (STEP_LOSS_REL, 1e-5 relative) or within twice the port's one-process
  distance to it (the two implementations round apart in float32), and
  the two ranks' parameters and statistics equal after the step;
- the port's dry run (multichip.dryrun_rank) in the same world.
One world of two processes (gloo, a file store under tmp_path) runs every
port side (`multichip.run_all`); each child holds torch to 2 threads and
imports the port only.
"""

import concurrent.futures
import functools
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from fusiondepth_tpu.parallel import multihost as jax_multihost
from fusiondepth_tpu.training import trainer as jax_trainer
from fusiondepth_tpu.training.train_state import TrainState, \
    split_variables
from fusiondepth_torch import multichip
from fusiondepth_torch.config import Config
from fusiondepth_torch.models.jax_weights import from_jax_variables, \
    to_jax_variables
from fusiondepth_torch.parallel import make_mesh, multihost
from fusiondepth_torch.training.trainer import Trainer

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import FAST_COMPILE, GENERIC, jit, \
    random_variables
from test_torch_port_train import (
    H,
    KW,
    SRC,
    W,
    assert_trees_close,
    jax_train_inputs,
    jax_train_side,
    make_inputs,
)

WORLD = 2
ACCUM, ACCUM_BATCH = 2, 4
SMALL = dict(num_layers=18, height=64, width=64, batch_size=2,
             weights_init="scratch", dataset="synthetic", num_workers=1)
# chip_smoke.py's STEP_LOSS_REL: a float32 step's loss, relative
F32_LOSS_REL = 1e-5
# the world's time limit; it takes ~25 s on an idle 8-core CPU
WORLD_S = 600


@pytest.mark.parametrize("case", [
    ("lines", 23, 4), ("lines", 3, 1), ("lines", 10, 4),
    ("batch", 12, 4), ("batch", 12, 1), ("batch", 10, 4)])
def test_shard_lines_and_local_batch_size_match_jax(case):
    """Every process's strided slice of the split and the local batch, as
    the JAX functions give them (an uneven batch raises in both)."""
    what, n, pc = case
    if what == "lines":
        lines = [f"l{i}" for i in range(n)]
        for pi in range(pc):
            assert multihost.shard_lines(lines, pi, pc) == \
                jax_multihost.shard_lines(lines, pi, pc)
    elif n % pc:
        with pytest.raises(AssertionError):
            jax_multihost.local_batch_size(n, pc)
        with pytest.raises(ValueError):
            multihost.local_batch_size(n, pc)
    else:
        assert multihost.local_batch_size(n, pc) == \
            jax_multihost.local_batch_size(n, pc)


def _noise(key, shape, n_scales=4):
    """The automask noise photometric.py draws from `key`, one per scale."""
    out, r = [], key
    for _ in range(n_scales):
        r, sub = jax.random.split(r)
        out.append(torch.from_numpy(np.asarray(
            jax.random.normal(sub, shape)) * 1e-5))
    return out


def _weights(variables, dtype):
    return {k: v.to(dtype) for k, v in from_jax_variables(variables).items()}


@pytest.fixture(scope="module")
def jax_mesh_trainer(tmp_path_factory):
    """The JAX Trainer with use_mesh on a (2,) data mesh, float32: its
    weights, first batch and noise, and its step on that batch under way
    ("loss", a future). Its state is built from random variables of the
    init's shapes (flax's eager init of the four encoders takes a minute
    on the CPU), its loggers write no TensorBoard file (importing
    TensorFlow takes 15 s) and its step is compiled with
    test_torch_port_models' FAST_COMPILE options; the Trainer's mesh,
    sharding and jitted meshed step are its own."""
    cfg = JaxConfig(**SMALL, use_mesh=True, mesh_shape=(WORLD,),
                    pallas_warp=False,
                    log_dir=str(tmp_path_factory.mktemp("jax_mesh")),
                    **GENERIC)

    def random_state(cfg, nets, rng, tx):
        params, stats = split_variables(random_variables(
            lambda: nets.init(rng, batch_size=1), np.random.default_rng(3)))
        return TrainState(params=params, batch_stats=stats,
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "create_train_state", random_state)
        mp.setattr(jax_trainer, "MetricLogger",
                   functools.partial(jax_trainer.MetricLogger, use_tb=False))
        mp.setattr(jax, "jit", functools.partial(jax.jit,
                                                 compiler_options=FAST_COMPILE))
        tr = jax_trainer.Trainer(
            cfg, train_dataset=JaxSynthetic(cfg, length=WORLD),
            val_dataset=None)
    assert tr.mesh.shape["data"] == WORLD
    _, key = jax.random.split(tr.rng)  # the key run_step takes
    out = dict(variables=jax.tree.map(np.asarray, tr.variables()),
               batch=next(iter(tr._loader(tr.train_dataset, shuffle=False))),
               noise=_noise(key, (len(SRC), WORLD, 64, 64)))
    # its step traces and compiles in a thread while the float64 step
    # compiles in this one (XLA's compile releases the GIL)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out["loss"] = pool.submit(
            lambda: float(tr.run_step(out["batch"])["loss"]))
        yield out


def accum_inputs():
    """A global batch of ACCUM_BATCH: jax_side's batch, then one made
    the same way from another seed; each microbatch's key (jax_side's,
    then another) and automask noise."""
    inputs = jax_train_inputs()
    keys = [inputs["key"], jax.random.PRNGKey(43)]
    with jax.enable_x64():
        noise = [inputs["noise"],
                 _noise(keys[1], (len(SRC), ACCUM_BATCH // ACCUM, H, W))]
    b = make_inputs(seed=8)
    return dict(batch={k: np.concatenate([v, b[k]])
                       for k, v in inputs["batch"].items()},
                keys=keys, noise=noise)


@pytest.fixture(scope="module")
def started_world(tmp_path_factory, jax_mesh_trainer):
    """Every port side of this module, started at once in one world of
    WORLD processes (gloo, on the CPU) from inputs that need no JAX
    compile, so that it runs while the JAX sides compile: the float64
    step with its probes, the microbatched step, the float32 Trainer step
    and the dry run."""
    inputs = jax_train_inputs()
    tmp = tmp_path_factory.mktemp("world")
    cfg64 = dict(KW, log_dir=str(tmp / "log"))
    weights64 = str(tmp / "weights64.pt")
    torch.save(_weights(inputs["variables"], torch.float64), weights64)
    accum = accum_inputs()
    specs = {
        "step": dict(cfg=cfg64, batch=inputs["batch"], weights=weights64,
                     noise=inputs["noise"], probe=True),
        "accum": dict(cfg={**cfg64, "batch_size": ACCUM_BATCH,
                           "grad_accum_steps": ACCUM},
                      batch=accum["batch"], noise=accum["noise"],
                      weights=weights64),
        "mesh": dict(cfg=dict(SMALL, log_dir=str(tmp / "log")),
                     batch=jax_mesh_trainer["batch"],
                     noise=[n.float() for n in jax_mesh_trainer["noise"]],
                     weights=str(tmp / "weights32.pt")),
    }
    torch.save(_weights(jax_mesh_trainer["variables"], torch.float32),
               specs["mesh"]["weights"])
    calls = []
    for name, spec in specs.items():
        torch.save(spec, tmp / f"{name}.pt")
        calls.append((multichip.step_rank, (str(tmp / f"{name}.pt"),)))
    calls.append((multichip.dryrun_rank, (str(tmp / "dryrun"),)))
    world = multichip.start(WORLD, multichip.run_all, calls, device="cpu")
    yield list(specs) + ["dryrun"], world
    world.close()
    for f in tmp.glob("*.pt"):  # ~0.6 GB of weights
        f.unlink()


@pytest.fixture(scope="module")
def jax_accum_side(started_world):
    """The JAX make_train_step with grad_accum_steps=2 at global batch 4,
    float64, from jax_side's weights: its microbatch loop
    (fusiondepth_tpu/training/train_state.py:116-133: the BN statistics
    carried from one microbatch to the next, the gradients summed and
    divided by 2, the losses averaged, Adam on the mean), its microbatch 0
    being jax_side's step itself (its batch, key and statistics) and its
    microbatch 1 a run of the loss-and-gradient program jax_side compiled
    on the statistics microbatch 0 leaves: one f64 compile serves both.
    The step's keys are given, not split from one key as make_train_step
    splits them: the port replays the noise. Returns the loss, and the
    parameters and BN statistics after the step."""
    side, accum = jax_train_side(), accum_inputs()
    mb = ACCUM_BATCH // ACCUM
    with jax.enable_x64():
        cfg = side["cfg"].replace(batch_size=ACCUM_BATCH,
                                  grad_accum_steps=ACCUM)
        params, _ = split_variables(side["variables"])
        part = {n: jnp.asarray(x[mb:]) for n, x in accum["batch"].items()}
        _, loss, grads, stats, _ = side["run"](
            params, side["new_stats"], part, accum["keys"][1])
        out = jax.tree.map(np.asarray, (params, grads, stats, loss))
    grads = jax.tree.map(lambda a, b: (a + b) / ACCUM, side["grads"], out[1])
    # optax.adam's first update from its init state (the moments (1 - b1) g
    # and (1 - b2) g^2, bias-corrected), at the schedule's first rate (the
    # JAX make_optimizer's lr * batch / 8), in numpy: jitting or running
    # tx.update on the tree costs 10-20 s here, and test 2 holds the
    # port's Adam against tx.update itself
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = cfg.learning_rate * cfg.batch_size / 8.0

    def adam(p, g):
        mu, nu = (1 - b1) * g, (1 - b2) * g * g
        return p - lr * (mu / (1 - b1)) / (np.sqrt(nu / (1 - b2)) + eps)

    return dict(new_params=jax.tree.map(adam, out[0], grads),
                new_stats=out[2], loss=(side["loss"] + float(out[3])) / ACCUM)


@pytest.fixture(scope="module")
def jax_mesh_side(started_world, jax_mesh_trainer):
    """The JAX meshed Trainer's loss on its first batch."""
    return jax_mesh_trainer["loss"].result()


@pytest.fixture(scope="module")
def world(started_world, jax_accum_side, jax_mesh_side):
    """The started world's results, per rank, once the JAX sides are
    done: {"step", "accum", "mesh", "dryrun"}."""
    jax_train_side()
    names, handle = started_world
    return [dict(zip(names, r)) for r in handle.join(timeout=WORLD_S)]


def _assert_ranks_equal(world, name):
    """Every rank ends a step with rank 0's loss, gradients and state."""
    ref = world[0][name]
    for r in world[1:]:
        assert r[name]["loss"] == ref["loss"]
        for part in ("grads", "state"):
            for k, v in ref[part].items():
                assert torch.equal(r[name][part][k], v), (part, k)


def _port_tree(named, key):
    return {k: v[key] for k, v in to_jax_variables(named).items()
            if key in v}


def test_world_of_two_matches_the_jax_step_f64(world):
    """Two ranks of one row each: the global loss, every all-reduced
    gradient leaf, the parameters after Adam and the BN running statistics
    against the JAX step on both rows, equal on both ranks; with per-rank
    BN statistics, or a per-rank SI loss, the loss would have missed its
    tolerance."""
    side = jax_train_side()
    got = world[0]["step"]
    assert abs(got["loss"] - side["loss"]) < 1e-7, (got["loss"],
                                                    side["loss"])
    assert_trees_close(_port_tree(got["grads"], "params"), side["grads"],
                       rtol=1e-5, atol=1e-9)
    assert_trees_close(_port_tree(got["state"], "params"),
                       side["new_params"], rtol=0, atol=1e-6)
    assert_trees_close(_port_tree(got["state"], "batch_stats"),
                       {k: v for k, v in side["new_stats"].items() if v},
                       rtol=0, atol=1e-9)
    assert not any(got["launches"].values())  # CPU: the plain versions
    _assert_ranks_equal(world, "step")
    for probe in ("local_bn", "local_si"):
        off = abs(world[0]["step"][probe] - side["loss"])
        assert off > 1e-7, (probe, off)


def test_world_of_two_microbatches_match_jax_grad_accum(world,
                                                       jax_accum_side):
    """grad_accum_steps=2 over two ranks at global batch 4: rank r holds
    the r-th half of each JAX microbatch, whose BN statistics cover its
    rows only; the loss, the parameters after Adam and the statistics
    carried through both microbatches match."""
    got = world[0]["accum"]
    assert abs(got["loss"] - jax_accum_side["loss"]) < 1e-7
    assert_trees_close(_port_tree(got["state"], "params"),
                       jax_accum_side["new_params"], rtol=0, atol=1e-6)
    assert_trees_close(_port_tree(got["state"], "batch_stats"),
                       {k: v for k, v in jax_accum_side["new_stats"].items()
                        if v}, rtol=0, atol=1e-9)
    _assert_ranks_equal(world, "accum")


def test_two_rank_trainer_matches_the_jax_mesh_trainer_f32(
        world, jax_mesh_trainer, jax_mesh_side, tmp_path):
    """The port's two-rank Trainer against the JAX Trainer on a (2,) mesh:
    one float32 step on the same weights, batch and noise. The two
    implementations round apart in float32, so the two-rank loss is held
    to the JAX loss within F32_LOSS_REL, or within twice the distance of
    the port's one-process step (the same Trainer without a mesh) to it,
    whichever is larger, and to that one-process loss within F32_LOSS_REL;
    both ranks end with the same parameters and statistics. The dry run's
    ranks agree on a finite loss."""
    cfg = Config(**SMALL, log_dir=str(tmp_path))
    one = Trainer(cfg, device="cpu")
    one.nets.load_state_dict(_weights(jax_mesh_trainer["variables"],
                                      torch.float32))
    single = float(one.run_step(jax_mesh_trainer["batch"],
                                noise=[n.float() for n in
                                       jax_mesh_trainer["noise"]])["loss"])
    want = jax_mesh_side
    limit = max(F32_LOSS_REL * abs(want), 2 * abs(single - want))
    got = world[0]["mesh"]["loss"]
    assert abs(got - want) <= limit, (got, want, single)
    assert abs(got - single) <= F32_LOSS_REL * abs(single), (got, single)
    _assert_ranks_equal(world, "mesh")
    losses = {r["dryrun"]["loss"] for r in world}
    assert len(losses) == 1 and np.isfinite(losses.pop())


@pytest.mark.parametrize("case", ["no_flags_no_op", "world_of_one_gloo"])
def test_maybe_initialize_distributed(case, monkeypatch):
    """No flag and no torchrun variables: a no-op, as the JAX function is
    without its flags. A coordinator on localhost, one process: a gloo
    group of one on the CPU, whose mesh runs no collective."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    if case == "no_flags_no_op":
        assert multihost.maybe_initialize_distributed(Config()) is False
        assert not torch.distributed.is_initialized()
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cfg = Config(coordinator_address=f"localhost:{port}", num_processes=1,
                 process_id=0)
    assert multihost.maybe_initialize_distributed(cfg, device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = make_mesh((1,), torch.device("cpu"))
        assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    finally:
        torch.distributed.destroy_process_group()


def test_batch_that_does_not_split_over_ranks_and_microbatches_raises():
    """B % (A W) != 0: the JAX package reshards; the port refuses, naming
    the ROADMAP item."""
    from fusiondepth_torch.parallel import Mesh, rank_rows

    mesh = Mesh(rank=0, world=2, device=torch.device("cpu"), group=None)
    assert rank_rows(8, mesh, 2) == [0, 1, 4, 5]
    assert rank_rows(8, mesh.__class__(1, 2, mesh.device, None), 2) == \
        [2, 3, 6, 7]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rank_rows(6, mesh, 2)
