"""The port's modules (fusiondepth_torch/models) against the flax modules
of the JAX package, with the JAX package's default TPU layout flags on and
the weights carried across by models/jax_weights.from_jax_variables.

float32 at B=2, 64x96 (R50 at 64x64): atol 5e-4, rtol 1e-3, the tolerance
of tests/test_resnet_torch_parity.py, since the two frameworks' convs sum
in different orders through a deep stack.
"""

import concurrent.futures
import contextlib
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config
from fusiondepth_torch.config import Config as PortConfig
from fusiondepth_tpu.models.depth_decoder import DepthDecoder as JaxDecoder
from fusiondepth_tpu.models.fusion import FusionNets as JaxFusionNets
from fusiondepth_tpu.models.norm import BatchNorm as JaxBatchNorm
from fusiondepth_tpu.models.resnet import ResnetEncoder as JaxEncoder
from fusiondepth_torch.models.depth_decoder import DepthDecoder
from fusiondepth_torch.models.jax_weights import (
    NETS,
    from_jax_variables,
    to_jax_variables,
)
from fusiondepth_torch.models.norm import BatchNorm
from fusiondepth_torch.models.resnet import RESNET_FEATURE_CHANNELS, \
    ResnetEncoder

B, H, W = 2, 64, 96
TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op torch threads for a port test module (the others
    import this fixture): the suite runs in several processes at once, and
    torch's default of one thread per core oversubscribes the CPU, which
    makes a train step ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_variables(init, rng, dtype=np.float32):
    """Variables of the tree `init()` would build, made with numpy instead:
    jax.eval_shape gives the shapes without running the init. Conv kernels
    get fan-in-scaled normals; BN scales, shifts and statistics and the
    conv biases get random values too (flax would start them at 1 and 0)."""
    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape) * fan_in ** -0.5
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.standard_normal(s.shape) * 0.1

    return jax.tree_util.tree_map_with_path(
        lambda p, s: fill(p, s).astype(dtype), jax.eval_shape(init))


# Most of the port tests' time is XLA's CPU compile of the JAX side. At
# LLVM optimization level 1 the f64 train step of
# tests/test_torch_port_train.py compiles in 24 s instead of 55 s and
# runs as fast (5 s against 6 s) on an 8-core x86 CPU; the numbers agree
# to the tests' tolerances either way.
FAST_COMPILE = {"xla_backend_optimization_level": 1}


# The JAX package's generic math: its TPU layout flags off. Each flag
# re-lays the same math out for the TPU and is pinned exact against the
# generic path by the JAX package's own suite (config.py:189-235); this
# file holds the port's modules against the flags on. The float64 step
# fixtures of the other port test files trace and compile the generic
# path, a third faster: a default-config step fixture took 27.3 s against
# 39.9 s with the flags on, in one CPU process.
GENERIC = dict(fold64_encoder=False, fold_stem=False, folded_seam=False,
               folded_decoder=False)


def jit(fn, **kwargs):
    """jax.jit with the FAST_COMPILE options."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kwargs)


class JaxSides:
    """The JAX sides of a port test module, each a function of this
    object run once in a thread (XLA's compile releases the GIL). When
    the module runs in one process they all start with its first test, so
    that the tests reading none run meanwhile; in a pytest-xdist worker,
    which may be handed a few of the module's tests only, a side starts
    when a test first reads it. `sides[name].result()` waits for one (a
    side may read another through the object it is given)."""

    def __init__(self, pool, jobs):
        self._pool, self._jobs, self._futures = pool, jobs, {}
        self._lock = threading.Lock()
        if os.environ.get("PYTEST_XDIST_WORKER") is None:
            for name in jobs:
                self._future(name)

    def _future(self, name):
        with self._lock:
            if name not in self._futures:
                self._futures[name] = self._pool.submit(self._jobs[name],
                                                        self)
            return self._futures[name]

    def __getitem__(self, name):
        return _Side(self, name)


class _Side:
    def __init__(self, sides, name):
        self._sides, self._name = sides, name

    def result(self):
        return self._sides._future(self._name).result()


@contextlib.contextmanager
def jax_sides_in_threads(threads=None, **jobs):
    """A JaxSides of `jobs` (functions of it) on `threads` threads (one a
    job by default: a job that waits for another must leave it one), for
    a module fixture."""
    with concurrent.futures.ThreadPoolExecutor(threads or len(jobs)) as pool:
        yield JaxSides(pool, jobs)


def load_into(module, net, variables):
    """Carry one net's JAX variables into a port module."""
    sd = from_jax_variables({net: variables})
    module.load_state_dict({k[len(net) + 1:]: v for k, v in sd.items()})


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("depth,in_ch,hw", [(18, 3, (H, W)), (18, 2, (H, W)),
                                            (50, 3, (64, 64))])
def test_encoder_matches_flax(depth, in_ch, hw):
    rng = np.random.default_rng(depth + in_ch)
    x = rng.uniform(0, 1, (B, *hw, in_ch)).astype(np.float32)
    jenc = JaxEncoder(depth=depth, in_channels=in_ch, fold64=True,
                      fold_stem=True)
    v = random_variables(lambda: jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    want = jit(lambda v, x: jenc.apply(v, x, train=False))(
        v, jnp.asarray(x))
    enc = ResnetEncoder(depth, in_ch).eval()
    load_into(enc, "encoder", v)
    with torch.no_grad():
        got = enc(nchw(x))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1),
                                   np.asarray(w), err_msg=f"level {lvl}",
                                   **TOL)


@pytest.mark.parametrize("cat2end", [False, True])
def test_decoder_matches_flax(cat2end):
    rng = np.random.default_rng(5)
    ch = RESNET_FEATURE_CHANNELS[18]
    shapes = [(B, H >> (i + 1), W >> (i + 1), c) for i, c in enumerate(ch)]
    feats = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    beams = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    two = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    jdec = JaxDecoder(cat2end=cat2end, folded=True)
    jf = [jnp.asarray(f) for f in feats]
    jb = [jnp.asarray(f) for f in beams]
    jt = jnp.asarray(two) if cat2end else None
    v = random_variables(lambda: jdec.init(
        jax.random.PRNGKey(1), jf, two_channel=jt), rng)
    want = jit(lambda v, f, t, b: jdec.apply(v, f, two_channel=t,
                                             beam_features=b))(v, jf, jt, jb)
    dec = DepthDecoder(ch, cat2end=cat2end)
    load_into(dec, "depth", v)
    with torch.no_grad():
        got = dec([nchw(f) for f in feats],
                  two_channel=nchw(two) if cat2end else None,
                  beam_features=[nchw(f) for f in beams])
    assert set(got) == set(want) == {("disp", s) for s in range(4)}
    for k in want:
        np.testing.assert_allclose(np.moveaxis(got[k].numpy(), 1, -1),
                                   np.asarray(want[k]), err_msg=str(k),
                                   **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_flax(train):
    rng = np.random.default_rng(7)
    C = 16
    x = rng.standard_normal((B, 6, 10, C)).astype(np.float32) * 2 + 0.5
    jbn = JaxBatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)
    v = random_variables(lambda: jbn.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    want, upd = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(C)
    load_into(bn, "encoder", v)
    bn.train(train)
    with torch.no_grad():
        got = bn(nchw(x))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = upd["batch_stats"] if train else v["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               atol=1e-6)
    # the affine the fused encoder conv takes is the same map
    bn.eval()
    with torch.no_grad():
        a, b = bn(nchw(x), return_affine=True)
        np.testing.assert_allclose(
            (nchw(x) * a[:, None, None] + b[:, None, None]).numpy(),
            bn(nchw(x)).numpy(), atol=1e-6)


def test_pretrained_loads_like_jax_import(tmp_path, monkeypatch):
    """A torchvision-format resnet18 checkpoint goes into the port's four
    encoders as the JAX package's torch import converts it: every tensor,
    the pose encoder's conv1 tiled over its two frames, the beam encoders'
    conv1 keeping their own init. Without a checkpoint they keep their
    init and a warning says so."""
    from fusiondepth_tpu.models.torch_import import load_pretrained_encoder
    from fusiondepth_torch.training.infer_driver import build_nets

    src = ResnetEncoder(18, 3, generator=torch.Generator().manual_seed(3))
    sd = {k: v + 0.01 * torch.arange(v.numel()).reshape(v.shape)
          for k, v in src.state_dict().items()}
    sd.update({"fc.weight": torch.zeros(10, 512), "fc.bias": torch.zeros(10),
               "bn1.num_batches_tracked": torch.tensor(5)})
    torch.save(sd, tmp_path / "resnet18-test.pth")
    cfg = PortConfig(num_layers=18, height=64, width=64,
                     pretrained_weights_path=str(tmp_path))
    got = to_jax_variables(build_nets(cfg, torch.device("cpu")).state_dict())
    pth = str(tmp_path / "resnet18-test.pth")
    own = {"params": {"conv1": got["beam_encoder"]["params"]["conv1"]}}
    own_bp = {"params": {
        "conv1": got["beam_encoder_pose"]["params"]["conv1"]}}
    want = {"encoder": load_pretrained_encoder(pth, 18, 3),
            "beam_encoder": load_pretrained_encoder(
                pth, 18, 2, existing_variables=own),
            # two frames: conv1 tiled over the pair and halved
            "pose_encoder": load_pretrained_encoder(pth, 18, 6, 2),
            "beam_encoder_pose": load_pretrained_encoder(
                pth, 18, 4, 2, existing_variables=own_bp)}
    for net in want:
        assert jax.tree.structure(got[net]) == jax.tree.structure(want[net])
        for a, b in zip(jax.tree.leaves(got[net]),
                        jax.tree.leaves(want[net])):
            np.testing.assert_array_equal(a, np.asarray(b))

    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    with pytest.warns(UserWarning, match="keep their random init"):
        nets = build_nets(cfg.replace(pretrained_weights_path=None),
                          torch.device("cpu"))
    assert torch.equal(nets.encoder.conv1.weight,
                       ResnetEncoder(18, 3).conv1.weight)


def test_conv_init_matches_flax_lecun_normal():
    """The seeded init draws from flax's default kernel distribution: the
    same bound and the same standard deviation (not the same numbers)."""
    w = ResnetEncoder(18, 3).layer3[1].conv1.weight.detach().numpy()
    want = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 3, 256, 256)))
    assert np.abs(w).max() <= np.abs(want).max() * 1.01
    np.testing.assert_allclose(w.std(), want.std(), rtol=0.01)
    np.testing.assert_allclose(w.std(), (9 * 256) ** -0.5, rtol=0.01)


def test_jax_weights_round_trip_is_exact():
    cfg = Config(num_layers=18, height=H, width=W, predictive_mask=True,
                 disable_automasking=True)
    nets = JaxFusionNets(cfg)
    v = random_variables(lambda: nets.init(jax.random.PRNGKey(0)),
                         np.random.default_rng(0))
    v = {k: v[k] for k in NETS if k in v}
    back = to_jax_variables(from_jax_variables(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
