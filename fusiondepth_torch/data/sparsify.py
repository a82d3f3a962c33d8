"""Beam sparsifier: downsample 64-beam velodyne scans to K beams (or a
random point subset) via polar-angle binning. A copy of
`fusiondepth_tpu/data/sparsify.py` (numpy only), so that the port runs
where JAX is not installed.

Behavioral parity with reference sparsify/sparsify.py:15-123 (same angle
grids, truncation-to-int binning, last-write-wins scatter, -1 sentinel,
range filter, 1.8x random-sample multiplier). Pure vectorized numpy.

Default 4-beam row selection is line_spec=[2, 7, 12, 16] with H=64, W=1024
(reference prepare_4beam_data_for_prediction.sh:2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_LINE_SPECS = {
    1: [7],
    2: [7, 12],
    3: [2, 7, 12],
    4: [2, 7, 12, 16],
}


def range_filter(points: np.ndarray) -> np.ndarray:
    """Keep points with x in [0, 120), y in [-50, 50), z in [-2.5, 1.5)."""
    m = (
        (points[:, 0] < 120)
        & (points[:, 0] >= 0)
        & (points[:, 1] < 50)
        & (points[:, 1] >= -50)
        & (points[:, 2] < 1.5)
        & (points[:, 2] >= -2.5)
    )
    return points[m]


def polar_angle_map(points: np.ndarray, H: int = 64, W: int = 1024
                    ) -> np.ndarray:
    """Bin points into an (H, W, 4) beam/azimuth map; -1 = empty.

    Later points overwrite earlier ones in the same bin (numpy fancy-index
    assignment order, matching the reference scatter).
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dtheta = np.radians(0.4 * 64.0 / H)
    dphi = np.radians(90.0 / W)

    d = np.sqrt(x * x + y * y + z * z)
    r = np.sqrt(x * x + y * y)
    d = np.where(d == 0, 1e-6, d)
    r = np.where(r == 0, 1e-6, r)

    phi = np.radians(45.0) - np.arcsin(y / r)
    phi_idx = np.clip((phi / dphi).astype(int), 0, W - 1)

    theta = np.radians(2.0) - np.arcsin(z / d)
    theta_idx = np.clip((theta / dtheta).astype(int), 0, H - 1)

    amap = -np.ones((H, W, 4))
    amap[theta_idx, phi_idx] = points[:, :4]
    return amap


def random_sample_mask(depth: np.ndarray, num: float,
                       max_depth: float = np.inf,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """Bernoulli point subsampling to ~`num` points (reference :15-29)."""
    rng = rng or np.random.default_rng()
    keep = depth > 0
    if np.isfinite(max_depth):
        keep &= depth <= max_depth
    n = keep.sum()
    if n == 0:
        return keep
    return keep & (rng.uniform(size=depth.shape) < float(num) / n)


def sparsify_beams(
    points: np.ndarray,
    nbeams: int = 4,
    H: int = 64,
    W: int = 1024,
    line_spec: Optional[Sequence[int]] = None,
    slice_step: int = 1,
    random_sample: int = 0,
    rng: Optional[np.random.Generator] = None,
    return_line_map: bool = False,
):
    """64-beam scan (N, 4) -> K-beam point list (M, 4).

    line_spec selects beam rows (default per `nbeams`); random_sample != 0
    instead keeps ~random_sample points uniformly (1.8x oversample factor,
    reference sparsify.py:81-87).
    """
    pts = range_filter(points)
    amap = polar_angle_map(pts, H=H, W=W)

    if line_spec is None and random_sample == 0:
        line_spec = DEFAULT_LINE_SPECS.get(nbeams)
    if line_spec is not None:
        lines = amap[np.asarray(line_spec), :, :]
    else:
        lines = amap[::slice_step, :, :]

    flat = lines.reshape(-1, 4)
    flat = flat[flat[:, 0] != -1.0]

    if random_sample != 0:
        depth = np.linalg.norm(flat, axis=1)
        mask = random_sample_mask(depth, random_sample * 1.8, rng=rng)
        flat = flat[mask]

    if return_line_map:
        return lines.copy(), flat.astype(np.float32)
    return flat.astype(np.float32)
