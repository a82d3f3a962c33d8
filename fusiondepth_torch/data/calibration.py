"""KITTI calibration object for rect-camera <-> image <-> velodyne
projections (used by GDC and the detection-export path).

A copy of `fusiondepth_tpu/data/calibration.py` (numpy only), so that the
port runs where JAX is not installed. Same math as reference
kitti_util_from_pse.py:47-216, re-derived: P_rect
factors as K [I | t] so image->rect is a closed-form unprojection.
"""

from __future__ import annotations

import numpy as np

from fusiondepth_torch.data.kitti_io import read_calib_file


class Calibration:
    """Holds P (3x4 rect->image), R0 (3x3 ref->rect), optional V2C (3x4).

    Accepts either a raw-KITTI `calib_cam_to_cam.txt`-style dict (keys
    P_rect_0{cam}, R_rect_00) or an object-detection calib dict (P2, R0_rect,
    Tr_velo_to_cam).
    """

    def __init__(self, calibs: dict, cam: int = 2):
        if f"P_rect_0{cam}" in calibs:
            self.P = np.reshape(calibs[f"P_rect_0{cam}"], (3, 4))
            self.R0 = np.reshape(calibs["R_rect_00"], (3, 3))
            P3 = np.reshape(calibs.get("P_rect_03", self.P), (3, 4))
        else:
            self.P = np.reshape(calibs[f"P{cam}"], (3, 4))
            self.R0 = np.reshape(calibs["R0_rect"], (3, 3))
            P3 = np.reshape(calibs.get("P3", self.P), (3, 4))

        self.V2C = None
        if "Tr_velo_to_cam" in calibs:
            self.V2C = np.reshape(calibs["Tr_velo_to_cam"], (3, 4))
        elif "R" in calibs and "T" in calibs:
            self.V2C = np.hstack(
                [np.reshape(calibs["R"], (3, 3)),
                 np.reshape(calibs["T"], (3, 1))])

        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)
        self.baseline = P3[0, 3] / (-self.f_u) - self.P[0, 3] / (-self.f_u)

    @classmethod
    def from_file(cls, path: str, cam: int = 2) -> "Calibration":
        return cls(read_calib_file(path), cam=cam)

    @classmethod
    def from_video_dir(cls, calib_dir: str, cam: int = 2) -> "Calibration":
        """Assemble from calib_cam_to_cam.txt + calib_velo_to_cam.txt."""
        import os

        d = dict(read_calib_file(
            os.path.join(calib_dir, "calib_cam_to_cam.txt")))
        d.update(read_calib_file(
            os.path.join(calib_dir, "calib_velo_to_cam.txt")))
        return cls(d, cam=cam)

    # ---- projections ----

    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """(N, 3) [u, v, depth] -> (N, 3) rect-camera XYZ.

        x = (u - c_u) z / f_u + b_x, y = (v - c_v) z / f_v + b_y.
        """
        z = uv_depth[:, 2]
        x = (uv_depth[:, 0] - self.c_u) * z / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * z / self.f_v + self.b_y
        return np.stack([x, y, z], axis=1)

    def project_rect_to_image(self, pts_rect: np.ndarray) -> np.ndarray:
        """(N, 3) rect XYZ -> (N, 2) image uv."""
        n = pts_rect.shape[0]
        hom = np.hstack([pts_rect, np.ones((n, 1))])
        uvw = hom @ self.P.T
        return uvw[:, :2] / uvw[:, 2:3]

    def project_velo_to_rect(self, pts_velo: np.ndarray) -> np.ndarray:
        assert self.V2C is not None, "no velo->cam extrinsics in this calib"
        n = pts_velo.shape[0]
        hom = np.hstack([pts_velo[:, :3], np.ones((n, 1))])
        ref = hom @ self.V2C.T
        return ref @ self.R0.T

    def project_velo_to_image(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))


def depth_map_to_point_cloud(depth: np.ndarray, calib: Calibration,
                             max_high: float = 1.0) -> np.ndarray:
    """Dense depth map -> rect-camera point cloud (one point per pixel).

    Equivalent of the GDC helper `depth2ptc` (reference gdc_old.py:66-71).
    """
    H, W = depth.shape
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uvd = np.stack([u.ravel(), v.ravel(), depth.ravel()], axis=1)
    return calib.project_image_to_rect(uvd)
