"""Synthetic on-disk KITTI tree writer (a copy of
`fusiondepth_tpu/data/fixtures.py` for the port, which runs where JAX is
not installed).

Generates a minimal KITTI RAW drive (calib, velodyne bins, K-beam bins,
2channel caches, the camera's jpgs), standing in for real KITTI data for
the offline GDC, its evaluation and the host-fed bench. The scene is a
flat ground plane plus a fronto-parallel wall so projections,
sparsification and GDC all see plausible geometry. The calib's native
resolution can be given (`native`, default (2 * height, 2 * width) as
there), so that GDC can run at KITTI's native 375 x 1242. For the same
seed the calib, jpgs and LiDAR files are the JAX fixture's.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from fusiondepth_torch.data.kitti_io import generate_depth_map
from fusiondepth_torch.data.sparsify import sparsify_beams
from fusiondepth_torch.data.two_channel import expand_two_channel, max_pool2

DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


def build_synthetic_kitti_tree(root: str, n_frames: int = 3,
                               height: int = 64, width: int = 96,
                               nbeams: int = 4, seed: int = 0,
                               native: Optional[Tuple[int, int]] = None
                               ) -> str:
    """Create the tree under `root`; returns `root`.

    2channel caches are written at (height, width), the network resolution
    the consuming config must use; the calib describes a camera of
    resolution `native` (rows, columns)."""
    date = DRIVE.split("/")[0]
    os.makedirs(f"{root}/{DRIVE}/velodyne_points/data", exist_ok=True)
    os.makedirs(f"{root}/{DRIVE}/{nbeams}beam", exist_ok=True)
    os.makedirs(f"{root}/{DRIVE}/2channel", exist_ok=True)

    # projections happen at the calib's S_rect shape and only pad/crop
    # afterwards (kitti_io.generate_depth_map)
    ih, iw = native if native is not None else (2 * height, 2 * width)
    fu = fv = 1.1 * iw / 2
    cu, cv = iw / 2, ih / 2
    with open(f"{root}/{date}/calib_cam_to_cam.txt", "w") as f:
        f.write(f"S_rect_02: {iw} {ih}\n"
                "R_rect_00: 1 0 0 0 1 0 0 0 1\n"
                f"P_rect_02: {fu} 0 {cu} 0 0 {fv} {cv} 0 0 0 1 0\n"
                f"P_rect_03: {fu} 0 {cu} {-0.54 * fu} 0 {fv} {cv} 0 "
                "0 0 1 0\n")
    with open(f"{root}/{date}/calib_velo_to_cam.txt", "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0 0 0\n")

    os.makedirs(f"{root}/{DRIVE}/image_02/data", exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        img = rng.uniform(0, 255, (ih, iw, 3)).astype(np.uint8)
        Image.fromarray(img).save(
            f"{root}/{DRIVE}/image_02/data/{i:010d}.jpg")
        n = 30000
        x = rng.uniform(2, 80, n)
        y = rng.uniform(-30, 30, n)
        z = np.full(n, -1.7) + rng.normal(0, 0.02, n)
        pts = np.stack([x, y, z, np.ones(n)], 1).astype(np.float32)
        wall = np.stack([np.full(4000, 25.0), rng.uniform(-10, 10, 4000),
                         rng.uniform(-1.5, 1.4, 4000), np.ones(4000)],
                        1).astype(np.float32)
        velo = np.concatenate([pts, wall])
        velo.tofile(f"{root}/{DRIVE}/velodyne_points/data/{i:010d}.bin")

        sparse = sparsify_beams(velo, nbeams=nbeams)
        sparse.tofile(f"{root}/{DRIVE}/{nbeams}beam/{i:010d}.bin")

        # 2channel cache at network resolution (projection at 2x then pool,
        # reference gen2channel.py:42-57)
        for flip in (False, True):
            d = generate_depth_map(
                f"{root}/{date}",
                f"{root}/{DRIVE}/{nbeams}beam/{i:010d}.bin",
                2, shape=(2 * height, 2 * width))
            d = max_pool2(d)
            if flip:
                d = np.fliplr(d)
            two = expand_two_channel(d, row_range=(0, height),
                                     col_range=(0, width))
            np.save(f"{root}/{DRIVE}/2channel/{i}_l_{flip}.npy",
                    two.astype(np.float32))
    return root
