"""Stage 2 of the port (training/refiner.py, refiner_driver.py, the refine
hooks of the depth decoder, the refiner's ops) against the JAX package.

The whole-loss comparisons run on the setup of
tests/test_refiner_torch_parity.py: ResNet-18 stage-1 nets and the
road + catxy + deep refine2d decoder at B=2, 64x96, the reference
refiner's defaults (refine_iter 1, refine_a0, GDC loss on scale 0 only),
in float64 on both sides with the same weights (carried by
models/jax_weights) and the same automask noise (the JAX draws replayed).
The JAX side is one jitted function per module, computed in a thread
from the module's start while the tests that do not read it run (they
come first), on the JAX package's generic
path (its TPU layout flags off, test_torch_port_models.GENERIC),
with the planes box3's products kept in float64
(test_torch_port_ops._box3_f64): the JAX Refiner's `entire_loss`
(make_refine_loss_fn with the stage-1 parameters trainable and their BN
statistics fixed, fusiondepth_tpu/training/refiner_driver.py:66-75) under
jax.value_and_grad, with its pseudo-3D maps and refined disparities read
out of that trace, one optax.adam step of the refine decoder (the frozen
refiner's) and one of the refine and stage-1 parameters together
(train_entire_net's). Without train_entire_net the JAX loss only stops
the gradient at the stage-1 outputs, so its value, its maps and its
refine2d gradients are the same numbers: one trace serves both modes.

Tolerances: the pseudo-3D maps and refined disparities to 1e-9; the loss
to 1e-7 absolute and every refine2d gradient leaf (and under
train_entire_net every stage-1 leaf) to rtol 1e-5, atol 1e-9, the bounds of the stage-1 train step
(tests/test_torch_port_train.py): the JAX box3 rounds to float32 even
under x64, and the refine loss's means accumulate in float32
(`to_optimise.mean(dtype=float32)`); the parameters after one Adam step
to atol 1e-6 (lr * g / (|g| + 1e-8) amplifies a 1e-9 gradient difference
near g = 0).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.models.depth_decoder import DepthDecoder as JaxDecoder
from fusiondepth_tpu.ops import geometry as jgeometry
from fusiondepth_tpu.ops import planes as jax_planes
from fusiondepth_tpu.ops import pooling as jpooling
from fusiondepth_tpu.training.refiner import RefinerNets as JaxRefinerNets
from fusiondepth_tpu.training.refiner import make_refine_loss_fn
from fusiondepth_tpu.training.refiner import refiner_si_loss as jax_si
from fusiondepth_torch.config import Config
from fusiondepth_torch.data.synthetic import SyntheticDataset
from fusiondepth_torch.models.depth_decoder import DepthDecoder
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.jax_weights import flatten, \
    from_jax_variables, to_jax_variables
from fusiondepth_torch.models.resnet import RESNET_FEATURE_CHANNELS
from fusiondepth_torch.ops.geometry import cat_xy
from fusiondepth_torch.ops.pooling import masked_median, max_pool2x2_ceil
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.eval_driver import evaluate, \
    predict_refined_disparities
from fusiondepth_torch.training.infer_driver import device_batch
from fusiondepth_torch.training.refiner import (
    REFINE_KEYS,
    RefinerNets,
    refine_loss,
    refiner_si_loss,
)
from fusiondepth_torch.training.refiner_driver import INFER_KEYS, Refiner

from test_torch_port_models import few_torch_threads  # noqa: F401
from test_torch_port_models import GENERIC, jax_sides_in_threads, jit, \
    load_into, nchw, random_variables
from test_torch_port_ops import _box3_f64
from test_torch_port_train import assert_trees_close

B, H, W = 2, 64, 96
KW = dict(num_layers=18, height=H, width=W, batch_size=B,
          compute_dtype="float64", weights_init="scratch")
CPU = torch.device("cpu")
SRC = (-1, 1)
STAGE1 = ("encoder", "beam_encoder", "depth", "pose_encoder",
          "beam_encoder_pose", "pose")


def t64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def test_max_pool2x2_ceil_matches_jax_on_odd_sizes():
    rng = np.random.default_rng(0)
    for h, w in ((8, 12), (7, 11), (1, 3), (5, 5)):
        x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
        want = np.asarray(jpooling.max_pool2x2_ceil(jnp.asarray(x)))
        got = max_pool2x2_ceil(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, -(-h // 2), -(-w // 2), 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["odd", "even", "empty"])
def test_masked_median_matches_jax(case):
    """The lower middle element for an even count, +inf for an empty
    mask, over the whole batch."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 10, 10, 1)).astype(np.float32)
    mask = np.zeros(x.shape, bool)
    if case != "empty":
        flat = rng.permutation(x.size)[:41 if case == "odd" else 40]
        mask.reshape(-1)[flat] = True
    want = float(jpooling.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    got = float(masked_median(torch.from_numpy(x), torch.from_numpy(mask)))
    assert got == want
    if case == "even":
        assert got == float(torch.median(torch.from_numpy(x[mask])))
    if case == "empty":
        assert got == float("inf")


def test_cat_xy_matches_jax_f64():
    rng = np.random.default_rng(2)
    depth = rng.uniform(1.0, 80.0, (B, H, W, 1))
    K = np.eye(4)[None].repeat(B, 0)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 50.0, 60.0, 48.0, 30.0
    inv_K = np.linalg.inv(K)
    with jax.enable_x64():
        want = np.asarray(jgeometry.cat_xy(jnp.asarray(depth),
                                           jnp.asarray(inv_K)))
    got = cat_xy(t64(depth), t64(inv_K)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_refiner_si_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.5, 20.0, (B, H, W))
    target = np.where(rng.uniform(size=pred.shape) < 0.5,
                      pred * rng.uniform(0.8, 1.2, pred.shape), 0.0)
    with jax.enable_x64():
        want = float(jax_si(jnp.asarray(pred), jnp.asarray(target), 2.0,
                            0.3))
    got = float(refiner_si_loss(t64(pred), t64(target), 2.0, 0.3))
    assert abs(got - want) < 1e-12
    assert float(refiner_si_loss(t64(pred), t64(target * 0), 2.0, 0.3)) == 0


def test_refine_decoder_tanh_head_matches_flax():
    """The refine decoder's other hooks: tanh heads, and the pseudo-3D
    maps without the XYZ channels (catxy off), in float32."""
    rng = np.random.default_rng(5)
    ch = RESNET_FEATURE_CHANNELS[18]
    shapes = [(B, H >> (i + 1), W >> (i + 1), c) for i, c in enumerate(ch)]
    feats = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    beams = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    maps = {("disp", i): rng.uniform(0, 1, (B, H >> i, W >> i, 3))
            .astype(np.float32) for i in range(4)}
    jdec = JaxDecoder(road=True, catxy=False, deep=True, tanh_head=True)
    jf = [jnp.asarray(f) for f in feats]
    jb = [jnp.asarray(f) for f in beams]
    jm = {k: jnp.asarray(v) for k, v in maps.items()}
    v = random_variables(lambda: jdec.init(jax.random.PRNGKey(1), jf,
                                           depth_maps=jm), rng)
    want = jit(lambda v, f, b, m: jdec.apply(
        v, f, beam_features=b, depth_maps=m))(v, jf, jb, jm)
    dec = DepthDecoder(ch, road=True, catxy=False, deep=True,
                       tanh_head=True)
    load_into(dec, "refine2d", v)
    with torch.no_grad():
        got = dec([nchw(f) for f in feats],
                  beam_features=[nchw(f) for f in beams],
                  depth_maps={k: nchw(m) for k, m in maps.items()})
    for k in want:
        g = np.moveaxis(got[k].numpy(), 1, -1)
        assert (np.abs(g) < 1).all() and (g < 0).any()  # tanh, not sigmoid
        np.testing.assert_allclose(g, np.asarray(want[k]), atol=2e-5,
                                   rtol=1e-4, err_msg=str(k))


class RefineFrames:
    """Synthetic frames carrying an inf_gdc target and a ground-truth
    depth each, with the parse_line of a KITTI split."""

    def __init__(self, cfg, n, seed=1):
        self.inner = SyntheticDataset(cfg, length=n, seed=seed)
        rng = np.random.default_rng(seed)
        self.gdc = rng.uniform(5.0, 30.0, (n, cfg.height, cfg.width, 1)) \
            .astype(np.float32)
        self.gt = rng.uniform(2.0, 60.0, (n, cfg.height, cfg.width)) \
            .astype(np.float32)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return {**self.inner[i], "inf_gdc": self.gdc[i],
                "depth_gt": self.gt[i]}


def test_refiner_epoch_checkpoint_and_refined_evaluation(tmp_path):
    """Refiner.run_epoch on the CPU over a stage-1 checkpoint, only the
    refine decoder moving; the refine checkpoint reloaded (and a .npz of
    JAX refine variables); evaluate with refine_2d over both."""
    cfg = Config(num_layers=18, height=64, width=96, batch_size=2,
                 weights_init="scratch", log_dir=str(tmp_path),
                 num_workers=1, log_frequency=1, eval_batch_size=2)
    stage1 = ckpt.save_checkpoint(cfg, FusionNets(cfg, device=CPU),
                                  "stage1")
    cfg = cfg.replace(refine_load_weights_folder=stage1)
    data = RefineFrames(cfg, 4)
    refiner = Refiner(cfg, train_dataset=data, val_dataset=data,
                      device="cpu")
    s1_before = {k: v.clone() for k, v in
                 refiner.nets.stage1.state_dict().items()}
    r_before = {k: v.clone() for k, v in
                refiner.nets.refine2d.state_dict().items()}
    losses = refiner.run_epoch()
    assert len(losses) == 2 and refiner.step == 2
    assert all(np.isfinite(float(x)) for x in losses)
    for k, v in refiner.nets.stage1.state_dict().items():
        assert torch.equal(v, s1_before[k]), k
    assert all(not torch.equal(v, r_before[k]) for k, v in
               refiner.nets.refine2d.state_dict().items())
    metrics = refiner.validate()
    assert np.isfinite(metrics["abs_rel"])
    path = refiner.save("t")

    reloaded = Refiner(cfg, device="cpu")
    reloaded.load(path)
    assert reloaded.step == 2
    for k, v in refiner.nets.refine2d.state_dict().items():
        assert torch.equal(reloaded.nets.refine2d.state_dict()[k], v), k
    o1 = refiner.optimizer.state_dict()["state"]
    o2 = reloaded.optimizer.state_dict()["state"]
    assert all(torch.equal(o1[i]["exp_avg_sq"], o2[i]["exp_avg_sq"])
               for i in o1)

    npz = str(tmp_path / "refine.npz")
    np.savez(npz, **flatten(to_jax(refiner)))
    with torch.no_grad():
        for p in reloaded.nets.refine2d.parameters():
            p.zero_()
    reloaded.load(npz)
    for k, v in refiner.nets.refine2d.state_dict().items():
        assert torch.equal(reloaded.nets.refine2d.state_dict()[k], v), k

    batch = device_batch({k: np.stack([data[i][k] for i in range(2)])
                          for k in INFER_KEYS}, CPU, INFER_KEYS)
    want = refiner.infer(batch)[..., 0].numpy()
    disps, gts = predict_refined_disparities(
        cfg.replace(load_weights_folder=path), data, device="cpu")
    assert len(disps) == len(gts) == 4
    np.testing.assert_allclose(np.stack(disps[:2]), want, atol=1e-6)
    ecfg = cfg.replace(load_weights_folder=path, post_process=True,
                       refine_2d=True)
    got = evaluate(ecfg, data, device="cpu")
    assert set(got) >= {"abs_rel", "rmse", "a1"}
    assert all(np.isfinite(v) for v in got.values())


def test_refiner_cli_needs_a_card(monkeypatch, tmp_path):
    from fusiondepth_torch import refiner as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the CLI's KITTI datasets read no file until a batch is drawn
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(["--num_layers", "18", "--height", "64", "--width", "96",
                  "--weights_init", "scratch", "--log_dir", str(tmp_path),
                  "--data_path", str(tmp_path)])


def make_inputs():
    """The batch of tests/test_refiner_torch_parity.py."""
    rng = np.random.default_rng(11)
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
    inf_gdc = rng.uniform(0.5, 1.5, (B, H, W, 1))
    K = np.zeros((B, 4, 4))
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    return {"color": color, "color_aug": color_aug, "two_channel": two_ch,
            "four_beam": four_beam, "inf_gdc": inf_gdc, "K": K,
            "inv_K": np.linalg.inv(K)}


def jax_refine_side():
    batch = make_inputs()
    with jax.enable_x64():
        cfg = JaxConfig(**KW, train_entire_net=True, pallas_warp=False,
                        **GENERIC)
        nets = JaxRefinerNets(cfg)
        rng = np.random.default_rng(0)
        frozen = random_variables(
            lambda: nets.stage1.init(jax.random.PRNGKey(0), batch_size=B),
            rng, np.float64)
        refine_params = random_variables(
            lambda: nets.init_refine(jax.random.PRNGKey(3), batch_size=B),
            rng, np.float64)
        stats = {k: v.get("batch_stats", {}) for k, v in frozen.items()}
        key = jax.random.PRNGKey(42)
        loss_fn = make_refine_loss_fn(cfg, nets)
        lr = cfg.learning_rate * B / 8.0
        tx = optax.adam(lr)

        # the pseudo-3D maps and the refined disparities, read out of the
        # loss's own trace (one compile of one forward)
        build, decoder, seen = nets.build_pseudo3d, nets.refine2d, {}

        class RecordingDecoder:
            def apply(self, *args, **kwargs):
                seen["refined"] = decoder.apply(*args, **kwargs)
                return seen["refined"]

        def recording_build(*args):
            seen["maps"] = build(*args)
            return seen["maps"]

        def loss_and_maps(trainable, batch, key):
            # entire_loss: the stage-1 parameters with their fixed BN
            # statistics
            fixed = {}
            for k, p in trainable["stage1"].items():
                fixed[k] = {"params": p}
                if stats[k]:
                    fixed[k]["batch_stats"] = stats[k]
            nets.build_pseudo3d, nets.refine2d = recording_build, \
                RecordingDecoder()
            try:
                loss, losses = loss_fn(trainable["refine"], fixed, batch,
                                       key)
            finally:
                del nets.build_pseudo3d
                nets.refine2d = decoder
            return loss, (losses, seen.pop("maps"), seen.pop("refined"))

        def run(trainable, batch, key):
            (loss, (losses, maps, refined)), grads = jax.value_and_grad(
                loss_and_maps, has_aux=True)(trainable, batch, key)
            rp = trainable["refine"]
            updates, _ = tx.update(grads["refine"], tx.init(rp), rp)
            every, _ = tx.update(grads, tx.init(trainable), trainable)
            return (maps, refined, loss, losses, grads,
                    optax.apply_updates(rp, updates),
                    optax.apply_updates(trainable, every))

        trainable = {"refine": refine_params,
                     "stage1": {k: v["params"] for k, v in frozen.items()}}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_planes, "box3", _box3_f64)
            out = jit(run)(trainable, {k: jnp.asarray(x)
                                       for k, x in batch.items()}, key)
        maps, refined, loss, losses, grads, new_rp, new_all = jax.tree.map(
            np.asarray, out)
        # the automask noise: loss_fn splits once per refine iteration,
        # _refine_losses once per scale
        _, sub = jax.random.split(key)
        noise = []
        for _ in cfg.scales:
            sub, s = jax.random.split(sub)
            noise.append(torch.from_numpy(np.asarray(jax.random.normal(
                s, (len(SRC), B, H, W))) * 1e-5))
    return dict(frozen={k: frozen[k] for k in STAGE1},
                refine_params=refine_params, batch=batch, maps=maps,
                refined=refined, loss=float(loss), losses=losses,
                grads=grads["refine"], entire_grads=grads,
                new_params=new_rp, new_entire=new_all, noise=noise, lr=lr)


@pytest.fixture(scope="module", autouse=True)
def jax_refine_step():
    """`jax_refine_side` under way in a thread from the module's first test
    on (XLA's compile releases the GIL; under pytest-xdist from the first
    test that reads it: `JaxSides`): the tests above run meanwhile."""
    with jax_sides_in_threads(step=lambda sides: jax_refine_side()) as sides:
        yield sides["step"]


@pytest.fixture(scope="module")
def jax_side(jax_refine_step):
    return jax_refine_step.result()


def port_nets(jax_side, **flags):
    nets = RefinerNets(Config(**KW, **flags), device=CPU)
    load_jax(nets, jax_side)
    return nets


def load_jax(nets, jax_side):
    nets.stage1.load_state_dict(from_jax_variables(jax_side["frozen"]))
    load_into(nets.refine2d, "refine2d", jax_side["refine_params"])


def port_batch(jax_side):
    return device_batch(jax_side["batch"], CPU, REFINE_KEYS, torch.float64)


def test_build_pseudo3d_matches_jax_f64(jax_side):
    nets = port_nets(jax_side)
    batch = port_batch(jax_side)
    outputs, _, _ = nets.frozen_forward(batch, poses=False)
    maps = nets.build_pseudo3d(batch, outputs)
    for s in range(4):
        want = jax_side["maps"][("disp", s)]
        assert tuple(maps[("disp", s)].shape) == want.shape == (
            B, H >> s, W >> s, 6)
        np.testing.assert_allclose(maps[("disp", s)].numpy(), want,
                                   atol=1e-9, rtol=0, err_msg=str(s))


def test_refine_decoder_matches_jax_f64(jax_side):
    """The road + catxy + deep decoder on the frozen features and the JAX
    pseudo-3D maps."""
    nets = port_nets(jax_side)
    batch = port_batch(jax_side)
    _, feats, beam_feats = nets.frozen_forward(batch, poses=False)
    maps = {k: torch.tensor(v) for k, v in jax_side["maps"].items()}
    with torch.no_grad():
        got = nets.refine(feats, beam_feats, maps)
    for k, want in jax_side["refined"].items():
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-9, rtol=0,
                                   err_msg=str(k))


def test_refine_loss_grads_and_one_adam_step_match_jax_f64(jax_side):
    """refine_loss and every refine2d gradient leaf against
    make_refine_loss_fn under jax.value_and_grad, then the refine decoder
    after one step of the refiner's Adam against optax.adam."""
    nets = port_nets(jax_side)
    cfg = Config(**KW)
    loss, losses = refine_loss(cfg, nets, port_batch(jax_side),
                               noise=[jax_side["noise"]])
    assert abs(loss.item() - jax_side["loss"]) < 1e-7, (
        loss.item(), jax_side["loss"])
    assert set(losses) == set(jax_side["losses"])
    loss.backward()
    assert all(p.grad is None for p in nets.stage1.parameters())
    grads = {f"refine2d.{n}": p.grad
             for n, p in nets.refine2d.named_parameters()}
    assert_trees_close(to_jax_variables(grads)["refine2d"],
                       jax_side["grads"], rtol=1e-5, atol=1e-9)
    opt = torch.optim.Adam(nets.refine2d.parameters(), lr=jax_side["lr"],
                           eps=1e-8)
    opt.step()
    got = to_jax_variables({f"refine2d.{n}": p.detach() for n, p in
                            nets.refine2d.named_parameters()})["refine2d"]
    assert_trees_close(got, jax_side["new_params"], rtol=0, atol=1e-6)


# ---- train_entire_net ----

def entire_grads(nets):
    """{"refine": ..., "stage1": {net: params}} of the port's gradients,
    the leaves the loss does not read (None) as zeros."""
    def tree(named):
        return to_jax_variables({n: torch.zeros_like(p) if p.grad is None
                                 else p.grad for n, p in named})

    return {"refine": tree(nets.refine2d.named_parameters(
                prefix="refine2d"))["refine2d"],
            "stage1": {k: v["params"] for k, v in tree(
                nets.stage1.named_parameters()).items()}}


def test_entire_net_loss_and_grads_match_jax_f64(jax_side):
    """train_entire_net: refine_loss with the stage-1 nets trainable, its
    loss and every gradient leaf against entire_loss's. The gradient
    reaches the encoders through the features, the depth decoder through
    the pseudo-3D maps and the pose nets through the warps; the depth
    decoder's heads at scales 1-3 are unread (refine_a0): 0 in JAX, None
    here."""
    nets = port_nets(jax_side, train_entire_net=True)
    loss, losses = refine_loss(nets.cfg, nets, port_batch(jax_side),
                               noise=[jax_side["noise"]])
    assert abs(loss.item() - jax_side["loss"]) < 1e-7, (
        loss.item(), jax_side["loss"])
    assert set(losses) == set(jax_side["losses"])
    loss.backward()
    unread = {n for n, p in nets.stage1.named_parameters() if p.grad is None}
    assert unread == {f"depth.dispconv_{s}.conv.{leaf}" for s in (1, 2, 3)
                      for leaf in ("weight", "bias")}
    assert_trees_close(entire_grads(nets), jax_side["entire_grads"],
                       rtol=1e-5, atol=1e-9)


def test_entire_net_run_step_matches_jax_and_keeps_bn_stats(jax_side,
                                                            tmp_path):
    """One Refiner.run_step with train_entire_net: the refine and stage-1
    parameters after its Adam step against the JAX step's, the stage-1
    BN running statistics unchanged (the checkpoint round trip is
    tests/test_torch_port_refiner_variants.py's, in float32)."""
    from fusiondepth_torch.training import refiner_driver

    cfg = Config(**KW, train_entire_net=True, log_dir=str(tmp_path))
    refiner = Refiner(cfg, device="cpu")
    load_jax(refiner.nets, jax_side)
    buffers = {n: b.clone() for n, b in refiner.nets.named_buffers()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(refiner_driver, "refine_loss",
                   lambda cfg, nets, b, generator=None: refine_loss(
                       cfg, nets, b, noise=[jax_side["noise"]]))
        losses = refiner.run_step(jax_side["batch"])
    assert abs(float(losses["loss"]) - jax_side["loss"]) < 1e-7
    for n, b in refiner.nets.named_buffers():
        assert torch.equal(b, buffers[n]), n
    got = to_jax(refiner, stage1=True)
    assert_trees_close(got.pop("refine2d"), jax_side["new_entire"]["refine"],
                       rtol=0, atol=1e-6)
    assert_trees_close({k: v["params"] for k, v in got.items()},
                       jax_side["new_entire"]["stage1"], rtol=0, atol=1e-6)


def to_jax(refiner, stage1=False):
    nets = {"refine2d": refiner.nets.refine2d}
    if stage1:
        nets.update(refiner.nets.stage1.named_children())
    return to_jax_variables(torch.nn.ModuleDict(nets).state_dict())
