"""2-channel sparse-LiDAR encoding: (expanded depth, confidence).

Behavioral parity with reference gen2channel.py:60-117, vectorized. The
reference's sequential per-pixel loop is order-independent once decomposed
by confidence level (center conf 1 > ring-1 conf 1/2 > ring-2 conf 1/3 ...):
for every target pixel the highest-confidence contributions win and equal-
confidence contributions average. That makes it a handful of shifted
accumulations instead of an O(H*W*expand^2) Python loop.

The reference ring offsets are (i+x, j+y) for |x|+|y| = dis with x != 0
(pure-column offsets are never generated — gen2channel.py:71-116 iterates
horizontal=1..dis), reproduced exactly by `ring_offsets`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def ring_offsets(dis: int) -> List[Tuple[int, int]]:
    """Offsets written at distance `dis` (reference loop order/dedup)."""
    offsets = []
    for h in range(1, dis + 1):
        x, y = h, dis - h
        offsets.append((x, y))
        if x != 0:
            offsets.append((-x, y))
        if y != 0:
            offsets.append((x, -y))
        if x != 0 and y != 0:
            offsets.append((-x, -y))
    return offsets


def expand_two_channel(
    sparse_depth: np.ndarray,
    expand: int = 2,
    row_range: Tuple[int, int] = (76, 190),
    col_range: Tuple[int, int] = (2, 638),
) -> np.ndarray:
    """Sparse depth (H, W) -> (H, W, 2) [expanded depth, confidence].

    Source pixels outside row_range/col_range are ignored entirely
    (reference gen2channel.py:65-66 loops i in [76,190), j in [2,638) for
    192x640; the completion variant uses its own window).
    """
    H, W = sparse_depth.shape
    src = np.zeros_like(sparse_depth, dtype=np.float64)
    r0, r1 = row_range
    c0, c1 = col_range
    src[r0:r1, c0:c1] = sparse_depth[r0:r1, c0:c1]

    levels = [(1.0, [(0, 0)])]
    for dis in range(1, expand + 1):
        levels.append((1.0 / (dis + 1), ring_offsets(dis)))

    pad = expand
    padded = np.pad(src, pad)

    expanded = np.zeros((H, W), np.float64)
    confidence = np.zeros((H, W), np.float64)
    filled = np.zeros((H, W), bool)

    # highest confidence first; once a pixel is claimed, lower levels skip it
    for conf, offsets in levels:
        ssum = np.zeros((H, W), np.float64)
        scnt = np.zeros((H, W), np.float64)
        for dx, dy in offsets:
            # value v at (i, j) contributes to (i+dx, j+dy): shift src
            shifted = padded[pad - dx: pad - dx + H, pad - dy: pad - dy + W]
            ssum += shifted
            scnt += shifted != 0
        take = (~filled) & (scnt > 0)
        expanded[take] = ssum[take] / scnt[take]
        confidence[take] = conf
        filled |= take

    return np.stack([expanded, confidence], axis=-1).astype(np.float32)


def max_pool2(x: np.ndarray) -> np.ndarray:
    """2x2 max pool with ceil_mode (reference gen2channel.py:51-53)."""
    H, W = x.shape
    Hp, Wp = -(-H // 2) * 2, -(-W // 2) * 2
    padded = np.full((Hp, Wp), -np.inf, x.dtype)
    padded[:H, :W] = x
    return padded.reshape(Hp // 2, 2, Wp // 2, 2).max(axis=(1, 3))


def sparse_beam_to_2channel(calib_dir: str, velo_filename: str, cam: int,
                            do_flip: bool, expand: int = 2,
                            proj_shape: Tuple[int, int] = (384, 1280),
                            **expand_kw) -> np.ndarray:
    """Full per-frame pipeline (reference gen2channel.py:42-117): project the
    sparse beams at 2x resolution, 2x2 max-pool to (192, 640), optional
    horizontal flip, then expand to the 2-channel encoding."""
    from fusiondepth_torch.data.kitti_io import generate_depth_map

    depth = generate_depth_map(calib_dir, velo_filename, cam,
                               shape=list(proj_shape))
    depth = max_pool2(depth)
    if do_flip:
        depth = np.fliplr(depth)
    return expand_two_channel(depth, expand=expand, **expand_kw)
