"""The sparse-3D refiner of the port (models/refine_net3d.py,
training/refiner3d.py, the refiner CLI's dispatch) against the JAX
package's (fusiondepth_tpu/models/refine_net3d.py,
fusiondepth_tpu/training/refiner3d.py), in float64 with the weights
carried by models/jax_weights.

- The voxel tables (voxelize, depth_to_voxels, neighbor_table,
  voxel_downsample, build_voxel_pyramid) integer-equal to JAX's, built
  from the same points or the same float64 depth, and the voxel features
  within 1e-12: a 3-point cloud, a 64x96 scene below its capacity, and
  the scene at a capacity below its unique-voxel count (the overflow
  voxels merge into the last slot).
- The three nets (Shallow, Deep, the Refiner3D U-Net) on JAX's tables:
  forward within 1e-9, every gradient leaf (the BN running statistics
  included: the nets run in eval mode) within rtol 1e-5, atol 1e-9, the
  bounds of tests/test_torch_port_refiner.py.
- One Refiner3D step at 64x96, batch 2, capacity 2048, with the Shallow
  net and with the U-Net: the stage-1 disparity and `infer` within 1e-9,
  the loss within 1e-7, every gradient leaf at the bounds above, and the
  variables after one Adam step (the running statistics included) within
  1e-6 (lr g / (|g| + 1e-8) amplifies a 1e-9 gradient difference near
  g = 0). The JAX side is the JAX Refiner3D's own jitted `train_step`
  (built by `_build_steps` on an object made without its __init__:
  flax's eager init of the stage-1 nets takes a minute) with its Adam
  wrapped so that the returned optimizer state also carries the
  gradient, its `_forward` wrapped so that a callback reads the refined
  disparity (`infer` is `_forward`'s first output), and its stage 1
  answering with the port's stage-1 disparity on the same weights (the
  port's forward_depth is held against the JAX FusionNets' by
  tests/test_torch_port_slice.py; each step compiles from its inputs'
  shapes while that disparity is computed).
  The JAX sides run in threads from the module's start
  (test_torch_port_models.JaxSides; XLA's compile releases the GIL), and
  the tests that read them come after those that do not need them. The
  JAX nets compute in float64 (`jax_net`); their variables fill the port
  nets' trees in JAX's layout from a seed (`net_variables`; flax's apply
  takes them, so no flax init is traced).

Cheaper: the selectors, the CLI's dispatch, the refusals (no card, bf16),
the weight trees both ways and the kernel's row layout, and one
Refiner3D.train() epoch on the CPU.
"""

import functools
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.models import refine_net3d as jnet
from fusiondepth_tpu.training import refiner3d as jrefiner3d
from fusiondepth_torch.config import Config
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.models import refine_net3d as pnet
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import from_jax_variables, \
    to_jax_variables
from fusiondepth_torch.training import refiner3d
from fusiondepth_torch.training.refiner3d import Refiner3D, \
    select_refine_net3d

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jax_sides_in_threads, jit, \
    load_into, random_variables
from test_torch_port_train import assert_trees_close

B, H, W = 2, 64, 96
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch")
DEPTH_NETS = ("encoder", "beam_encoder", "depth")
NET_FLAGS = ("refine_shallow", "refine_deep", "refineUnet")
STEP_FLAGS = ("refine_shallow", "refineUnet")
# the scene's voxel capacity in the nets' tests: 2048 holds its 1515
# voxels; the U-Net's level 0 overflows at 1024, its levels 1-3 do not
NET_CAPACITY = {"refine_shallow": 2048, "refine_deep": 2048,
                "refineUnet": 1024}
# the step's voxel size spreads the random stage-1 net's depths (a few
# decimetres) over ~1000 voxels a sample
STEP_VOXEL, STEP_CAPACITY = 0.02, 2048
GRAD_TOL = dict(rtol=1e-5, atol=1e-9)
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def scene_depth():
    """A smooth 64x96 float64 depth (4-19 m, rising towards the top, with
    a ripple and 0.1 m of noise: 1515 voxels of 0.5 m, ~12 neighbours
    each) and its KITTI-like inverse intrinsics."""
    rng = np.random.default_rng(0)
    v, u = np.mgrid[0:H, 0:W]
    depth = 4.0 + 12.0 * (1 - v / H) + 3.0 * np.sin(u / 9) \
        + 0.1 * rng.standard_normal((H, W))
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * W, 1.92 * H, W / 2, H / 2
    return depth, np.linalg.inv(K)


def shared(fn):
    """functools.lru_cache whose callers wait while another computes (the
    JAX threads and the tests share these results: one compile each)."""
    lock, cached = threading.Lock(), functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        with lock:
            return cached(*args)

    return call


@shared
def jax_scene(capacity):
    """JAX's depth_to_voxels of the scene, jitted, as numpy."""
    depth, inv_K = scene_depth()
    with jax.enable_x64():
        out = jit(jnet.depth_to_voxels, static_argnums=(2, 3))(
            jnp.asarray(depth), jnp.asarray(inv_K), 0.5, capacity)
        return [np.asarray(x) for x in out]


@shared
def jax_pyramid(capacity, levels=3):
    """JAX's build_voxel_pyramid of the scene, jitted (one compile)."""
    coords, _, valid, _, keys = jax_scene(capacity)
    with jax.enable_x64():
        tables, c2p = jit(jnet.build_voxel_pyramid, static_argnums=(3, 4))(
            jnp.asarray(coords), jnp.asarray(keys), jnp.asarray(valid),
            levels, capacity)
        return ([{k: np.asarray(v) for k, v in tb.items()} for tb in tables],
                [np.asarray(m) for m in c2p])


@shared
def jax_neighbors(capacity):
    """JAX's neighbor_table of the scene's voxels, jitted."""
    coords, _, valid, _, keys = jax_scene(capacity)
    with jax.enable_x64():
        return np.asarray(jit(jnet.neighbor_table, static_argnums=3)(
            coords, keys, valid, tuple(jnet._kernel_offsets(3))))


def jax_net(flag):
    """The JAX net a selector names, computing in float64: flax's
    SparseConv3D casts its product's operands to its `dtype` attribute,
    float32 by default even under x64; the port's computes in its
    parameters' dtype."""
    return jrefiner3d.select_refine_net3d(
        JaxConfig(**KW, **{flag: True})).clone(dtype=jnp.float64)


def net_inputs(flag, capacity):
    """The scene's level-0 inputs of the net `flag` selects, JAX's tables:
    (feats, neighbours, valid) or (feats, tables, child-to-parent maps),
    as numpy."""
    _, feats, valid, _, _ = jax_scene(capacity)
    if flag == "refineUnet":
        tables, c2p = jax_pyramid(capacity)
        return feats, tables, c2p
    return feats, jax_neighbors(capacity), valid


def to_jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(t, tree)


def net_variables(flag, rng):
    """Random float64 variables of the net `flag` selects, filled from
    `rng` (`random_variables`) over the tree of the port's net carried to
    JAX's layout (flax's init would trace the net; the nets test holds
    flax's apply to this tree)."""
    tree = to_jax_variables({f"refine3d.{k}": v for k, v in
                             select_refine_net3d(Config(**KW, **{flag: True}))
                             .state_dict().items()})["refine3d"]
    return random_variables(lambda: tree, rng, np.float64)


def jax_net_side(flag):
    """The net `flag` selects: its forward and the gradient of <out,
    cotangent> with respect to all of its variables, batch_stats
    included, float64."""
    rng = np.random.default_rng(NET_FLAGS.index(flag) + 1)
    capacity = NET_CAPACITY[flag]
    inputs = net_inputs(flag, capacity)
    net = jax_net(flag)
    variables = net_variables(flag, rng)
    cot = rng.standard_normal((capacity, 1))
    with jax.enable_x64():
        def fwd_vjp(v, args):
            y, vjp = jax.vjp(lambda v: net.apply(v, *args), v)
            return y, vjp(jnp.asarray(cot))[0]

        y, grads = jax.tree.map(np.asarray, jit(fwd_vjp)(
            variables, to_jnp(inputs)))
    return dict(inputs=inputs, variables=variables, cot=cot, out=y,
                grads=grads)


class FixedStage1:
    """The JAX Refiner3D's stage 1, answering forward_depth with the
    disparity the batch carries (the JAX FusionNets' own, compiled
    once)."""

    def forward_depth(self, variables, batch, train):
        return {("disp", 0): batch["stage1_disp"]}, None, None


def recording(tx):
    """`tx` whose state also carries the last gradient it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def step_inputs():
    rng = np.random.default_rng(11)
    color = rng.uniform(0, 1, (B, 1, H, W, 3))
    two_ch = np.zeros((B, 1, H, W, 2))
    hit = rng.uniform(size=(B, 1, H, W)) < 0.15
    d = rng.uniform(2.0, 20.0, (B, 1, H, W))
    two_ch[..., 0] = np.where(hit, d / 100.0, 0.0)
    two_ch[..., 1] = np.where(hit, 1.0 / (d + 1.0), 0.0)
    K = np.zeros((B, 4, 4))
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    return {"color_aug": color, "two_channel": two_ch,
            "four_beam": np.zeros((B, H, W, 1)), "inv_K": np.linalg.inv(K)}


def stage1_side():
    """The stage-1 weights, the step's batch with a GDC target near the
    stage-1 depth, and the stage-1 disparity both step sides are given:
    the port's forward_depth in float64 on weights filled from a seed over
    the depth branch's JAX tree (test_torch_port_slice.py holds that
    forward against the JAX FusionNets'; the JAX Refiner3D's stage 1
    answers with this disparity, `FixedStage1`)."""
    rng = np.random.default_rng(2)
    batch = step_inputs()
    nets = FusionNets(Config(**KW), device=CPU)
    tree = to_jax_variables(nets.state_dict())
    frozen = random_variables(
        lambda: {k: tree[k] for k in DEPTH_NETS}, rng, np.float64)
    nets.load_state_dict({**nets.state_dict(), **from_jax_variables(frozen)})
    with torch.no_grad():
        disp = nets.forward_depth(
            {k: t(v) for k, v in batch.items()})[0][("disp", 0)].numpy()
    depth = 1.0 / (0.01 + 9.99 * disp[..., 0])
    target = depth * 30.0 * rng.uniform(0.9, 1.1, depth.shape)
    batch["inf_gdc"] = np.where(rng.uniform(size=depth.shape) < 0.7,
                                target, 0.0)[..., None]
    return dict(frozen=frozen, batch=batch, disp=disp)


def jax_step_side(flag, stage1):
    """One JAX Refiner3D step with the net `flag` selects on the batch and
    stage-1 disparity of `stage1` (`stage1_side`'s, waited for with its
    `result()`): its
    variables, the loss, the gradient, the variables after one Adam step
    and the refined disparity of the loss's forward, which is `infer`'s on
    the variables before the step (read out of the step by a callback: no
    second compile of the forward)."""
    rng = np.random.default_rng(STEP_FLAGS.index(flag) + 3)
    with jax.enable_x64():
        fcfg = JaxConfig(**KW, **GENERIC, **{flag: True})
        r = jrefiner3d.Refiner3D.__new__(jrefiner3d.Refiner3D)
        r.net = jax_net(flag)
        r.cfg, r.voxel_size, r.capacity = fcfg, STEP_VOXEL, STEP_CAPACITY
        r.is_unet = isinstance(r.net, jnet.RefineNet3DUNet)
        r.stage1 = FixedStage1()
        r.tx = recording(optax.adam(fcfg.learning_rate * B / 8.0))
        seen = {}
        forward = r._forward

        def recording_forward(nv, frozen, b):
            out = forward(nv, frozen, b)
            # as uint32 pairs: the callback runs where x64 is off, which
            # would round a float64 operand to float32
            jax.debug.callback(
                lambda d: seen.__setitem__("infer", np.asarray(d).view(
                    np.float64)[..., 0]),
                jax.lax.bitcast_convert_type(out[0], jnp.uint32))
            return out

        r._forward = recording_forward
        r._build_steps()
        variables = net_variables(flag, rng)

        def step(nv, b):
            new, (_, grads), loss = r.train_step(nv, r.tx.init(nv), None, b)
            return loss, grads, new

        # traced and compiled from the batch's shapes while the stage-1
        # disparity is computed
        maps = np.zeros((B, H, W, 1))
        spec = {k: jax.ShapeDtypeStruct(np.shape(x), jnp.asarray(x).dtype)
                for k, x in {**step_inputs(), "inf_gdc": maps,
                             "stage1_disp": maps}.items()}
        compiled = jit(step).lower(variables, spec).compile()
        s1 = stage1.result()
        out = compiled(variables, to_jnp({**s1["batch"],
                                          "stage1_disp": s1["disp"]}))
        loss, grads, new = jax.tree.map(np.asarray, out)
    return dict(variables=variables, loss=float(loss), grads=grads, new=new,
                infer=seen["infer"])


@pytest.fixture(scope="module", autouse=True)
def jax_sides():
    """The JAX sides on three threads (`JaxSides`: all from the module's
    first test on, or under pytest-xdist each from the test that reads
    it): the port's stage-1 disparity, each net's step (compiled before
    it reads that disparity) and each net's forward and gradients
    ("net_<flag>")."""
    with jax_sides_in_threads(
            threads=3,
            stage1=lambda sides: stage1_side(),
            refineUnet=lambda sides: jax_step_side("refineUnet",
                                                   sides["stage1"]),
            refine_shallow=lambda sides: jax_step_side(
                "refine_shallow", sides["stage1"]),
            **{f"net_{flag}": functools.partial(
                lambda sides, flag: jax_net_side(flag), flag=flag)
               for flag in NET_FLAGS}) as sides:
        yield sides


# ---- the port alone ----

@pytest.mark.parametrize("flags,want", [
    ({}, None), ({"refine_shallow": True}, "RefineNet3DShallow"),
    ({"refine_deep": True}, "RefineNet3DDeep"),
    ({"refineUnet": True}, "RefineNet3DUNet"),
    ({"refine_shallow": True, "refineUnet": True}, ValueError)])
def test_selectors_map_to_the_jax_nets(flags, want):
    """The net each selector names, with the JAX package's widths; more
    than one selector raises (JAX: an AssertionError)."""
    if want is ValueError:
        with pytest.raises(ValueError, match="at most one"):
            select_refine_net3d(Config(**KW, **flags))
        with pytest.raises(AssertionError):
            jrefiner3d.select_refine_net3d(JaxConfig(**KW, **flags))
        return
    net = select_refine_net3d(Config(**KW, **flags))
    jnet_ = jrefiner3d.select_refine_net3d(JaxConfig(**KW, **flags))
    if want is None:
        assert net is None and jnet_ is None
        return
    assert type(net).__name__ == type(jnet_).__name__ == want
    assert net.widths == tuple(jnet_.widths)


@pytest.mark.parametrize("flag", NET_FLAGS)
def test_refiner_cli_sends_a_selector_to_refiner3d(flag, monkeypatch,
                                                   tmp_path):
    """`python -m fusiondepth_torch.refiner --<selector>` trains a
    Refiner3D (stubbed here: no step runs), not the 2-D Refiner."""
    from fusiondepth_torch import refiner as cli
    from fusiondepth_torch.training import refiner_driver

    seen = []

    class Stub:
        def __init__(self, cfg, train, val):
            seen.append((cfg, train, val))

        def train(self):
            seen.append("train")

    def no_2d(*args, **kwargs):
        raise AssertionError("the 2-D Refiner was built")

    monkeypatch.setattr(refiner3d, "Refiner3D", Stub)
    monkeypatch.setattr(refiner_driver, "Refiner", no_2d)
    cli.main(["--num_layers", "18", "--height", "64", "--width", "96",
              "--weights_init", "scratch", "--log_dir", str(tmp_path),
              "--data_path", str(tmp_path), f"--{flag}"])
    assert len(seen) == 2 and seen[1] == "train"
    cfg, train, val = seen[0]
    assert getattr(cfg, flag) and train is not None and val is not None


def test_refiner3d_needs_a_card_and_refuses_bf16(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Refiner3D(Config(**{**KW, "compute_dtype": "float32"},
                         refineUnet=True))
    with pytest.raises(NotImplementedError, match="sparse-3D refiner"):
        Refiner3D(Config(**{**KW, "compute_dtype": "bfloat16"},
                         refineUnet=True), device="cpu")


@pytest.mark.parametrize("flag", NET_FLAGS)
def test_voxel_weights_round_trip(flag):
    """JAX variables (filled as the nets test's, which flax's apply takes)
    -> the port's state dict -> JAX variables, and the port's own init ->
    JAX -> the port, both exact; the kernels keep their (27 C_in, C_out)
    shape."""
    v = net_variables(flag, np.random.default_rng(3))
    ours = select_refine_net3d(Config(**KW, **{flag: True})).double()
    load_into(ours, "refine3d", v)
    back = to_jax_variables({f"refine3d.{k}": x for k, x in
                             ours.state_dict().items()})["refine3d"]
    assert_trees_close(back, v, rtol=0, atol=0)
    sd = {f"refine3d.{k}": x for k, x in select_refine_net3d(
        Config(**KW, **{flag: True})).state_dict().items()}
    again = from_jax_variables(to_jax_variables(sd))
    assert again.keys() == sd.keys()
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    assert all(x.shape[0] % 27 == 0 for x in sd.values() if x.dim() == 2)


def test_sparse_conv_kernel_rows_are_offset_major():
    """Row k C_in + c of the kernel takes input channel c of the
    neighbour at offset k of `_kernel_offsets`."""
    coords, feats, valid, _, keys = (t(x) for x in jax_scene(2048))
    nb = pnet.neighbor_table(coords, keys, valid, pnet._kernel_offsets(3))
    conv = pnet.SparseConv3D(2, 1).double()
    for k, c in ((0, 1), (13, 0), (22, 1)):
        with torch.no_grad():
            conv.weight.zero_()
            conv.weight[k * 2 + c, 0] = 1.0
            out = conv(feats, nb, valid)[:, 0]
        want = torch.where((nb[:, k] >= 0) & valid,
                           feats[nb[:, k].clamp(min=0).long(), c], 0.0)
        assert torch.equal(out, want), (k, c)


# ---- against the JAX package ----

@pytest.mark.parametrize("case", ["three_points", "scene", "overflow"])
def test_voxelize_matches_jax(case):
    """Integer-equal tables (coords, valid, point-to-voxel, keys) and the
    features within 1e-12."""
    if case == "three_points":
        pts = np.array([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [1.1, 0.0, 0.0]])
        vals = np.array([[1.0], [3.0], [5.0]])
        with jax.enable_x64():
            want = [np.asarray(x) for x in jit(
                jnet.voxelize, static_argnums=(2, 3))(pts, vals, 0.5, 8)]
        got = pnet.voxelize(t(pts), t(vals), 0.5, 8)
    else:
        capacity = 2048 if case == "scene" else 1024
        want = jax_scene(capacity)
        depth, inv_K = scene_depth()
        got = pnet.depth_to_voxels(t(depth), t(inv_K), 0.5, capacity)
    got = [x.numpy() for x in got]
    for name, g, w in zip(("coords", "feats", "valid", "p2v", "keys"), got,
                          want):
        assert g.shape == w.shape, name
        if name == "feats":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    n_valid = int(want[2].sum())
    if case == "three_points":
        assert n_valid == 2 and sorted(got[1][got[2], 0]) == [2.0, 5.0]
    elif case == "scene":
        assert n_valid == 1515
    else:  # more unique voxels than slots: the last slot takes the rest
        assert n_valid == 1024 and (got[3] == 1023).sum() > 1


def test_neighbor_table_matches_jax():
    """On the scene's voxels below capacity (invalid slots query
    _KEY_INVALID - 1), integer-equal."""
    coords, _, valid, _, keys = jax_scene(2048)
    want = jax_neighbors(2048)
    got = pnet.neighbor_table(t(coords), t(keys), t(valid),
                              pnet._kernel_offsets(3)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[valid, 13] == np.arange(2048)[valid]).all()
    assert (got[valid] >= 0).sum() > 10 * valid.sum()
    assert (got[~valid] == -1).all()


@pytest.mark.parametrize("flag", NET_FLAGS)
def test_net_forward_and_grads_match_jax_f64(flag, jax_sides):
    """Forward within 1e-9 and every gradient leaf of <out, cotangent>
    (params and the eval-mode BN's running statistics) on JAX's
    tables."""
    side = jax_sides[f"net_{flag}"].result()
    net = select_refine_net3d(Config(**KW, **{flag: True})).double()
    load_into(net, "refine3d", side["variables"])
    out = net(*to_torch(side["inputs"]))
    np.testing.assert_allclose(out.detach().numpy(), side["out"], rtol=0,
                               atol=1e-9)
    out.backward(t(side["cot"]))
    grads = to_jax_variables({f"refine3d.{n}": p.grad
                              for n, p in net.named_parameters()})
    assert_trees_close(grads["refine3d"], side["grads"], **GRAD_TOL)


def test_voxel_pyramid_and_downsample_match_jax():
    """build_voxel_pyramid over 3 levels from capacity 1024 (512, 256 and
    the 256 floor; level 0 overflows) integer-equal, and
    voxel_downsample's mean features within 1e-12."""
    capacity = 1024
    coords, feats, valid, _, keys = jax_scene(capacity)
    want_t, want_c = jax_pyramid(capacity)
    got_t, got_c = pnet.build_voxel_pyramid(t(coords), t(keys), t(valid),
                                            3, capacity)
    assert [tb["coords"].shape[0] for tb in got_t] == [1024, 512, 256, 256]
    for lvl, (g, w) in enumerate(zip(got_t, want_t)):
        for k in w:
            assert np.array_equal(g[k].numpy(), w[k]), (lvl, k)
    for g, w in zip(got_c, want_c):
        assert np.array_equal(g.numpy(), w)
    with jax.enable_x64():
        want = [np.asarray(x) for x in jit(
            jnet.voxel_downsample, static_argnums=4)(coords, keys, valid,
                                                     feats, 512)]
    got = [x.numpy() for x in pnet.voxel_downsample(
        t(coords), t(keys), t(valid), t(feats), 512)]
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 3:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        else:
            assert np.array_equal(g, w), i


@pytest.mark.parametrize("flag", STEP_FLAGS)
def test_refiner3d_step_matches_jax_f64(flag, jax_sides, tmp_path):
    """One Refiner3D.run_step against the JAX Refiner3D's train_step, and
    Refiner3D.infer against its infer, on the same stage-1 and voxel-net
    weights (the Refiner3D's stage 1 gives the disparity the JAX step was
    given)."""
    side = jax_sides["stage1"].result()
    want = jax_sides[flag].result()
    cfg = Config(**KW, log_dir=str(tmp_path), **{flag: True})
    r = Refiner3D(cfg, voxel_size=STEP_VOXEL, capacity=STEP_CAPACITY,
                  device="cpu")
    r.stage1.load_state_dict({**r.stage1.state_dict(),
                              **from_jax_variables(side["frozen"])})
    load_into(r.net, "refine3d", want["variables"])
    batch = r.put_batch(side["batch"])
    disp, _ = r.stage1.forward_depth(batch)
    np.testing.assert_allclose(disp[("disp", 0)].numpy(), side["disp"],
                               rtol=0, atol=1e-9)
    n_valid = pnet.depth_to_voxels(
        1.0 / (0.01 + 9.99 * disp[("disp", 0)][0, ..., 0]),
        batch["inv_K"][0], STEP_VOXEL, STEP_CAPACITY)[2].sum()
    assert 256 < n_valid < STEP_CAPACITY
    np.testing.assert_allclose(r.infer(batch).numpy(), want["infer"],
                               rtol=0, atol=1e-9)
    loss = float(r.run_step(side["batch"]))
    assert abs(loss - want["loss"]) < 1e-7, (loss, want["loss"])
    grads = to_jax_variables({f"refine3d.{n}": p.grad
                              for n, p in r.net.named_parameters()})
    assert_trees_close(grads["refine3d"], want["grads"], **GRAD_TOL)
    new = to_jax_variables({f"refine3d.{n}": p.detach()
                            for n, p in r.net.named_parameters()})
    assert_trees_close(new["refine3d"], want["new"], rtol=0, atol=1e-6)
    moved = want["new"]["batch_stats"]
    assert any(not np.array_equal(moved[m]["mean"],
                                  want["variables"]["batch_stats"][m]["mean"])
               for m in moved)


# ---- the port alone, after the JAX sides (no compile competes) ----

def test_2d_refiner_ignores_the_3d_selectors(tmp_path):
    """The 2-D Refiner reads no selector, as the JAX package's does."""
    from fusiondepth_torch.training.refiner_driver import Refiner

    cfg = Config(num_layers=18, height=H, width=W, batch_size=B,
                 weights_init="scratch", log_dir=str(tmp_path),
                 beam_encoder=False, refineUnet=True)
    assert Refiner(cfg, device="cpu").nets.refine2d is not None


class Refine3DFrames:
    """Synthetic frames carrying an inf_gdc target."""

    def __init__(self, cfg, n):
        self.inner = SyntheticDataset(cfg, length=n, seed=1)
        self.gdc = np.random.default_rng(1).uniform(
            5.0, 30.0, (n, cfg.height, cfg.width, 1)).astype(np.float32)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return {**self.inner[i], "inf_gdc": self.gdc[i]}


def test_refiner3d_train_epoch_on_the_cpu(tmp_path, capsys):
    """Refiner3D.train() with the U-Net over 4 frames at batch 2 (one
    epoch): finite losses, every voxel-net leaf moved (the BN running
    statistics too), stage 1 fixed."""
    cfg = Config(num_layers=18, height=H, width=W, batch_size=B,
                 weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1, log_frequency=1, num_epochs=1,
                 refineUnet=True)
    r = Refiner3D(cfg, train_dataset=Refine3DFrames(cfg, 4),
                  voxel_size=STEP_VOXEL, capacity=STEP_CAPACITY,
                  device="cpu")
    s1 = {k: v.clone() for k, v in r.stage1.state_dict().items()}
    before = {k: v.clone() for k, v in r.net.state_dict().items()}
    r.train()
    assert r.step == 2
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("refine3d epoch 0")]
    assert len(lines) == 2
    assert all(np.isfinite(float(x.split()[6])) for x in lines)
    assert all(torch.equal(v, s1[k]) for k, v in r.stage1.state_dict().items())
    assert all(not torch.equal(v, before[k])
               for k, v in r.net.state_dict().items())
