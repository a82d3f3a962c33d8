"""GDC of the port (fusiondepth_torch/gdc, kernels/knn.py,
training/gdc_driver.py) against the JAX package, on the CPU, where the
KNN wrapper takes its plain version.

Both sides compute in float32, as the JAX gdc_correct does by
construction. The KNN is exact on both sides and rounds the squared
distances alike, so the neighbour graphs are equal. What differs is the
summation order of the batched solves and of the CG dot products, and
the float32 CG amplifies it: on the
toy scene the corrected depths agree to a relative 7e-7 after 5 CG
iterations, 6e-6 after 20, 1e-3 after 30 and 4.5e-4 where the port's CG
stops (45 iterations). The tests hold the depths to GDC_RTOL = 1e-3
relative, and the LiDAR anchors exactly.

The fixture tree's systems are worse conditioned: with the full CG, the
two sides stop a few iterations apart (the port after 67 on one frame,
JAX later), and the iterates still move by up to 13% between those
iterations. The cache test therefore runs both drivers with the CG held
to TREE_CG_ITERS = 20 iterations, where the caches agree to 4.6e-4
relative (measured), and holds them to GDC_RTOL; that includes the
port's resize in place of cv2's (3e-6 relative apart).
"""

import functools
import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusiondepth_tpu.config import Config as JaxConfig
from fusiondepth_tpu.data.fixtures import DRIVE, build_synthetic_kitti_tree
from fusiondepth_tpu.gdc import gdc as jgdc
from fusiondepth_tpu.training import gdc_driver as jdriver
from fusiondepth_torch.config import Config
from fusiondepth_torch.gdc import gdc
from fusiondepth_torch.kernels import build
from fusiondepth_torch.kernels import knn as knn_kernel
from fusiondepth_torch.ops.resize import resize_linear_np
from fusiondepth_torch.training import gdc_driver

from test_torch_port_models import few_torch_threads  # noqa: F401

GDC_RTOL = 1e-3
TREE_CG_ITERS = 20


def _sorted_dists(pts, idx):
    return np.sort(np.linalg.norm(pts[:, None] - pts[idx], axis=-1), 1)


def test_plain_knn_matches_knn_brute():
    """A cloud with duplicated points (exact ties), a regular grid (many
    equidistant neighbours) and padded rows at the far sentinel, spread
    along x by index as gdc_correct places them."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(600, 3)) * 5).astype(np.float32)
    pts[300:330] = pts[:30]
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(2),
                                indexing="ij"), -1).reshape(-1, 3)
    pts[400:528] = grid * 0.5
    n_pad = 40
    pts[-n_pad:] = 1e8
    pts[-n_pad:, 0] += np.arange(len(pts) - n_pad, len(pts))
    valid = np.arange(len(pts)) < len(pts) - n_pad
    got = knn_kernel.knn(torch.from_numpy(pts), 10).numpy()
    want = np.asarray(jgdc.knn_brute(jnp.asarray(pts), jnp.asarray(valid),
                                     k=10, block=128))
    assert got.dtype == np.int32 and got.shape == want.shape
    real = pts[valid]
    np.testing.assert_allclose(_sorted_dists(real, got[valid]),
                               _sorted_dists(real, want[valid]), atol=1e-5)
    # with the same distances and ties to the lower index, the same rows
    np.testing.assert_array_equal(got[valid], want[valid])
    assert (got[valid] < len(pts) - n_pad).all()


# ---- the KNN kernel's arithmetic and schedule, modelled ----
# The CUDA kernel cannot run here; these hold its arithmetic (the products
# taken with 2q) and its schedule (queries a thread, point ranges, the
# seeded bound, the self test in the insert path, the merge), written in
# torch ops with the kernel's own constants, to the plain version that
# chip_smoke.py holds the kernel to on the card, and to the JAX knn_brute.

def _knn_constants(*names):
    text = (build.CSRC / "knn.cu").read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names]


def _insert(bd, bi, rows, d, j):
    """knn.cu::insert on the rows `rows` of the (N, K) lists: (d, j) into
    the last slot, then bubbled ahead past strictly larger distances."""
    K = bd.shape[1]
    bd[rows, K - 1] = d
    bi[rows, K - 1] = j
    for k in range(K - 1, 0, -1):
        a, b = bd[rows, k], bd[rows, k - 1]
        ia, ib = bi[rows, k], bi[rows, k - 1]
        sw = a < b
        bd[rows, k - 1] = torch.where(sw, a, b)
        bi[rows, k - 1] = torch.where(sw, ia, ib)
        bd[rows, k] = torch.where(sw, b, a)
        bi[rows, k] = torch.where(sw, ib, ia)


def _knn_scheduled(points, k, S):
    """knn_partial_kernel + knn_merge_kernel over S point ranges, in
    float32: squared distances from 2q through the float64-then-round
    `_fma`; each query's list seeded just above its k-th smallest distance
    to its SEED_PER_K * k index neighbours; tiles padded with NaN points to
    the UNROLL points of a step; a query takes the insert path for the
    step's points together when any distance is below its k-th (the points
    then inserted in index order, the self test inside); then the ranges'
    lists merged in range order."""
    TILE, UNROLL, SEED_PER_K = _knn_constants("TILE", "UNROLL",
                                              "SEED_PER_K")
    fma = knn_kernel._fma
    N = points.shape[0]
    p = points.float()
    sq, two = knn_kernel._sqnorm(p), 2 * p

    def dist(q, c, csq):  # aligned query and point rows
        qc2 = fma(two[q, 2], c[..., 2], fma(two[q, 1], c[..., 1],
                                           two[q, 0] * c[..., 0]))
        return (sq[q] - qc2) + csq

    qs = torch.arange(N)
    m = min(SEED_PER_K * k, N - 1)
    lo = torch.clamp(qs - m // 2, 0, N - 1 - m)
    win = lo[:, None] + torch.arange(m + 1)
    d = dist(qs[:, None], p[win], sq[win])
    d = torch.where((win == qs[:, None]) | d.isnan(), torch.inf, d)
    tau = torch.sort(d, 1)[0][:, k - 1]
    bound = torch.nextafter(tau, torch.tensor(torch.inf))

    chunk = -(-N // S)
    part_d, part_i = [], []
    int_max = torch.iinfo(torch.int32).max
    for s in range(S):
        bd = bound[:, None].repeat(1, k)
        bi = torch.full((N, k), int_max, dtype=torch.int64)
        r0, r1 = s * chunk, min(N, (s + 1) * chunk)
        for t0 in range(r0, r1, TILE):
            n = min(TILE, r1 - t0)
            for j0 in range(t0, t0 + -(-n // UNROLL) * UNROLL, UNROLL):
                js = range(j0, j0 + UNROLL)
                d = [dist(qs, p[j], sq[j]) if j < t0 + n
                     else torch.full((N,), float("nan")) for j in js]
                # compared with the k-th distances as they stand before
                hit = torch.stack([dj < bd[:, k - 1] for dj in d], 1).any(1)
                for j, dj in zip(js, d):
                    rows = hit & (dj < bd[:, k - 1]) & (qs != j)
                    _insert(bd, bi, rows, dj[rows], j)
        part_d.append(bd)
        part_i.append(bi)

    bd = torch.full((N, k), torch.inf)
    bi = torch.full((N, k), int_max, dtype=torch.int64)
    for s in range(S):
        alive = torch.ones(N, dtype=torch.bool)
        for kk in range(k):
            d = part_d[s][:, kk]
            alive &= d < bd[:, k - 1]  # the rest of the list is no better
            _insert(bd, bi, alive, d[alive], part_i[s][alive, kk])
    return bi.to(torch.int32)


def _tied_cloud():
    """About 300 points: a raster-like half sorted along x (index
    neighbours near in space, so the seeded bound is tight), a random half
    (a loose bound), six points at exactly distance 1 around a point far
    from the rest (exact ties: every term of d^2 is an integer), 15
    duplicated points (exact zero distances) and 30 rows at the far
    sentinel, spread along x by index as gdc_correct places them."""
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(301, 3)) * 3).astype(np.float32)
    pts[:150] = pts[:150][np.argsort(pts[:150, 0])]
    pts[160] = 50.0
    pts[161:167] = 50.0 + np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                                    [0, -1, 0], [0, 0, 1], [0, 0, -1]])
    pts[200:215] = pts[30:45]
    n_pad = 30
    pts[-n_pad:] = 1e8
    pts[-n_pad:, 0] += np.arange(len(pts) - n_pad, len(pts))
    valid = np.arange(len(pts)) < len(pts) - n_pad
    return pts, valid


@pytest.mark.parametrize("k, S", [(10, 3), (10, 7), (16, 2)])
def test_knn_kernel_schedule_matches_plain_and_knn_brute(k, S):
    """The kernel's schedule gives the plain version's indices on every
    row, sentinel rows included (both round d^2 alike), and JAX
    knn_brute's on the real rows; with S ranges that do not divide N."""
    pts, valid = _tied_cloud()
    got = _knn_scheduled(torch.from_numpy(pts), k, S)
    want = knn_kernel.knn_plain(torch.from_numpy(pts), k)
    assert torch.equal(got, want)
    jax_idx = np.asarray(jgdc.knn_brute(jnp.asarray(pts), jnp.asarray(valid),
                                        k=k, block=128))
    np.testing.assert_array_equal(got.numpy()[valid], jax_idx[valid])
    # the six exact ties come in index order
    assert got[160, :6].tolist() == list(range(161, 167))


def _f32_nearest(x: Fraction) -> np.float32:
    """x rounded once to float32, to nearest, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.int32)) & 1))


def _fma32(a, b, c):
    """A true float32 fused multiply-add: a * b + c exactly, rounded once."""
    return _f32_nearest(Fraction(float(a)) * Fraction(float(b))
                        + Fraction(float(c)))


def test_doubled_query_products_are_twice_the_dot_bit_for_bit():
    """fma(2q2, c2, fma(2q1, c1, 2q0 c0)), the kernel's products, is
    2 (q.c) with q.c = fma(q2, c2, fma(q1, c1, q0 c0)), bit for bit, with
    true float32 fmas: on random metre-scale coordinates, on zeros of
    both signs, powers of two, exact halves and GDC's sentinels."""
    rng = np.random.default_rng(9)
    edge = np.array([0.0, -0.0, 1.0, -2.0, 0.5, 1e8, 1e8 + 40959,
                     -1e-3, 3.0e-2, 80.0, 1.5, 0.1], np.float32)
    q = np.concatenate([rng.normal(size=(150, 3)) * 20,
                        rng.choice(edge, (60, 3))]).astype(np.float32)
    c = np.concatenate([rng.normal(size=(150, 3)) * 20,
                        rng.choice(edge, (60, 3))]).astype(np.float32)
    two = np.float32(2.0)
    for qi, ci in zip(q, c):
        dot = _fma32(qi[2], ci[2], _fma32(qi[1], ci[1], qi[0] * ci[0]))
        q2 = two * qi
        got = _fma32(q2[2], ci[2], _fma32(q2[1], ci[1], q2[0] * ci[0]))
        assert np.array_equal(np.float32(two * dot).view(np.int32),
                              np.float32(got).view(np.int32)), (qi, ci)


def test_lle_weights_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(5, 50, size=64).astype(np.float32)
    nb = rng.integers(0, 64, size=(64, 10)).astype(np.int32)
    valid = np.arange(64) < 56
    want = np.asarray(jgdc.lle_weights(jnp.asarray(x), jnp.asarray(nb),
                                       jnp.asarray(valid), W_tol=3e-5))
    got = gdc.lle_weights(torch.from_numpy(x), torch.from_numpy(nb),
                          torch.from_numpy(valid), 3e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert (got[~valid] == 0).all()


def _toy_scene(H=48, W=64):
    """tests/test_gdc.py's scene: a smooth depth ramp, the prediction 5%
    too far, anchors on a sparse grid."""
    v = np.arange(H)[:, None]
    gt_dense = 10.0 + 0.1 * np.tile(np.arange(W), (H, 1)) + 0.05 * v
    pred = (gt_dense * 1.05).astype(np.float32)
    gt_sparse = np.zeros((H, W), np.float32)
    gt_sparse[::6, ::4] = gt_dense[::6, ::4]
    return (W / 2, H / 2, 100.0, 100.0, 0.0, 0.0), pred, gt_sparse


def test_gdc_correct_matches_jax_on_the_toy_scene():
    calib, pred, gt = _toy_scene()
    kw = dict(k=6, cap_pl=4096, cap_l=256, maxiter=100,
              consider_range=(-90.0, 90.0), depth_agree=5.0)
    want, winfo = jgdc.gdc_correct(
        jnp.asarray(pred), jnp.asarray(gt),
        jgdc.GDCCalib(*[jnp.asarray(c, jnp.float32) for c in calib]),
        knn_block=256, return_info=True, **kw)
    got, info = gdc.gdc_correct(torch.from_numpy(pred), torch.from_numpy(gt),
                                gdc.GDCCalib(*calib), return_info=True,
                                **kw)
    got, want = got.numpy(), np.asarray(want)
    assert info["n_pl"] == int(winfo["n_pl"])
    assert info["n_l"] == int(winfo["n_l"])
    assert info["overflow"] == bool(winfo["overflow"])
    assert 0 < info["cg_iters"] < 100
    m = gt > 0
    np.testing.assert_array_equal(got[m], gt[m])
    np.testing.assert_allclose(got, want, rtol=GDC_RTOL)
    assert np.abs(got - pred).max() > 0.1  # the correction moved depths


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """tests/test_pipeline_e2e.py's 3-frame synthetic drive, with
    inf_depth caches (random disparities at the network size) for GDC."""
    root = str(tmp_path_factory.mktemp("kitti"))
    build_synthetic_kitti_tree(root, n_frames=3)
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(root, DRIVE, "inf_depth_4beam"))
    for i in range(3):
        disp = rng.uniform(0.02, 0.3, (1, 1, 64, 96)).astype(np.float32)
        np.save(os.path.join(root, DRIVE, "inf_depth_4beam", f"{i}_l.npy"),
                disp)
    return root


def test_run_inf_gdc_matches_jax(kitti_tree, monkeypatch):
    """The offline GDC cache of three frames, with small capacities and
    the CG held to TREE_CG_ITERS iterations on both sides."""
    monkeypatch.setattr(jdriver, "gdc_correct", functools.partial(
        jgdc.gdc_correct, maxiter=TREE_CG_ITERS))
    monkeypatch.setattr(gdc_driver, "gdc_correct", functools.partial(
        gdc.gdc_correct, maxiter=TREE_CG_ITERS))
    lines = [f"{DRIVE} {i} l" for i in range(3)]
    caps = dict(cap_pl=4096, cap_l=1024)
    kw = dict(num_layers=18, height=64, width=96, data_path=kitti_tree)
    assert jdriver.run_inf_gdc(JaxConfig(**kw), lines, **caps) == 3
    out = os.path.join(kitti_tree, DRIVE, "inf_gdc_4beam")
    want = [np.load(os.path.join(out, f"{i}_l.npy")) for i in range(3)]
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    assert gdc_driver.run_inf_gdc(Config(**kw), lines, device="cpu",
                                  **caps) == 3
    for i in range(3):
        got = np.load(os.path.join(out, f"{i}_l.npy"))
        assert got.dtype == np.float32 and got.shape == want[i].shape
        assert np.isfinite(got).all()
        rel = np.abs(got - want[i]) / np.maximum(np.abs(want[i]), 1e-6)
        assert rel.max() <= GDC_RTOL, (i, rel.max())


def test_port_fixture_tree_matches_jax_fixture_tree(tmp_path):
    """The port's copy of the fixture writer writes the JAX fixture's
    calib, jpgs and LiDAR bins byte for byte for the same seed, and its
    2channel caches to float32 rounding (the JAX fixture expands them
    through the JAX package's native library where it loads, the port
    through the numpy path)."""
    from fusiondepth_torch.data import fixtures

    a, b = tmp_path / "jax", tmp_path / "port"
    build_synthetic_kitti_tree(str(a), n_frames=1)
    fixtures.build_synthetic_kitti_tree(str(b), n_frames=1)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) == 7
    assert sorted(p.relative_to(b) for p in b.rglob("*")
                  if p.is_file()) == files
    for f in files:
        if f.suffix == ".npy":
            np.testing.assert_allclose(np.load(b / f), np.load(a / f),
                                       rtol=1e-6, err_msg=str(f))
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_run_inf_gdc_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        gdc_driver.run_inf_gdc(Config(), [])


@pytest.mark.parametrize("src,dst", [((64, 96), (128, 192)),
                                     ((128, 192), (64, 96)),
                                     ((192, 640), (375, 1242)),
                                     ((375, 1242), (192, 640)),
                                     ((7, 5), (3, 11))])
def test_resize_linear_matches_cv2(src, dst):
    """The port's resize in place of cv2.resize(INTER_LINEAR), up and
    down, on float32 maps."""
    import cv2
    a = np.random.default_rng(3).uniform(0.5, 80, src).astype(np.float32)
    want = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_linear_np(a, *dst)
    assert got.dtype == np.float32 and got.shape == dst
    np.testing.assert_allclose(got, want, rtol=1e-5)
