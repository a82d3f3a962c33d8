"""KITTI raw-data IO: velodyne scans, calibration files, LiDAR->depth-map
projection.

Behavioral parity with reference kitti_utils.py:8-102 (including the
KITTI-matlab `round(x) - 1` pixel convention and min-depth dedup), but the
reference's per-duplicate Python loop (kitti_utils.py:83-89) is replaced by
one vectorized scatter-min — last-write + min-over-duplicates is exactly a
minimum scatter.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def load_velodyne_points(filename: str) -> np.ndarray:
    """Load an Nx4 float32 velodyne scan; reflectance -> 1 (homogeneous)."""
    points = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def read_calib_file(path: str) -> dict:
    """Parse a KITTI calib text file into {key: float array | str}."""
    data = {}
    with open(path, "r") as f:
        for line in f.readlines():
            line = line.rstrip()
            if not line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value
    return data


def velo_to_image_projection(calib_dir: str, cam: int = 2
                             ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """P_velo2im (3x4) and rectified image shape (H, W) for camera `cam`."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam
    return P_velo2im, (int(im_shape[0]), int(im_shape[1]))


def project_points_to_depth(velo: np.ndarray, P_velo2im: np.ndarray,
                            im_shape: Tuple[int, int],
                            vel_depth: bool = False) -> np.ndarray:
    """Scatter velodyne points into a sparse per-pixel depth image.

    Keeps the reference's conventions: drop points behind the image plane
    (x < 0 in velo frame), KITTI-matlab `round - 1` pixel indices, minimum
    depth wins on collisions, negative depths zeroed.
    """
    H, W = im_shape

    velo = velo[velo[:, 0] >= 0]

    pts = velo @ P_velo2im.T  # (N, 3)
    z = pts[:, 2]
    u = np.round(pts[:, 0] / z) - 1
    v = np.round(pts[:, 1] / z) - 1
    d = velo[:, 0] if vel_depth else z

    valid = (u >= 0) & (v >= 0) & (u < W) & (v < H)
    u = u[valid].astype(np.int64)
    v = v[valid].astype(np.int64)
    d = d[valid]

    depth = np.full(H * W, np.inf, dtype=np.float64)
    np.minimum.at(depth, v * W + u, d)
    depth[~np.isfinite(depth)] = 0.0
    depth = depth.reshape(H, W)
    depth[depth < 0] = 0.0
    return depth


def pad_or_crop(depth: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Pad (top / x-centered) or crop to `shape`, reference
    kitti_utils.py:92-101 semantics. Targets narrower/shorter than the
    source (never produced by the reference's fixed shapes) are handled by
    exact center/top cropping so small test resolutions work."""
    if shape[1] < depth.shape[1]:
        # narrower target (never produced by the reference's fixed shapes):
        # exact center-crop width + top-crop height, bypass the quirky path
        x0 = (depth.shape[1] - shape[1]) // 2
        depth = depth[:, x0: x0 + shape[1]]
        if shape[0] < depth.shape[0]:
            depth = depth[depth.shape[0] - shape[0]:, :]
        return depth
    crop = shape[0] < depth.shape[0]
    ypad = abs(shape[0] - depth.shape[0])
    xpad = shape[1] - depth.shape[1]
    xpad1 = xpad // 2
    depth = np.pad(depth, ((ypad, 0), (xpad1, xpad - xpad1)))
    if crop:
        depth = depth[2:, :]
    return depth


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False,
                       shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Sparse depth image for one frame (reference kitti_utils.py:40-102)."""
    P_velo2im, im_shape = velo_to_image_projection(calib_dir, cam)
    velo = load_velodyne_points(velo_filename)
    depth = project_points_to_depth(velo, P_velo2im, im_shape, vel_depth)
    if shape is not None:
        depth = pad_or_crop(depth, shape)
    return depth


def readlines(filename: str) -> list:
    with open(filename, "r") as f:
        return f.read().splitlines()
