"""Offline GDC runner (reference inf_gdc.py:41-110; counterpart of
`fusiondepth_tpu/training/gdc_driver.py`): for every frame of the given
split lines, load the cached inf_depth disparity that `Infer.run_split`
wrote, convert it to metric depth at the LiDAR's native resolution,
median-scale it against the K-beam LiDAR inside the eigen crop, run GDC
on the card, and cache inf_gdc_{n}beam/{idx}_{side}.npy.

The reference fans a CPU process pool over frames (pykdtree + scipy); here
one frame's correction runs on the card (the KNN kernel, batched solves,
matrix-free CG), frame after frame. A GDC result that is not finite (the
reference's bare `except: print`) falls back to the uncorrected depth,
as in the JAX package. The resizes are the port's own cv2-INTER_LINEAR
resize (`ops/resize.py::resize_linear_np`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.calibration import Calibration
from fusiondepth_torch.data.kitti_io import generate_depth_map
from fusiondepth_torch.gdc.gdc import GDCCalib, gdc_correct
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.resize import resize_linear_np
from fusiondepth_torch.training.evaluation import garg_crop_mask
from fusiondepth_torch.training.infer_driver import resolve_device


def median_scale_to_beams(pred_depth: np.ndarray, beam_depth: np.ndarray
                          ) -> np.ndarray:
    """Eigen-crop median ratio scaling (reference inf_gdc.py:65-73)."""
    gh, gw = beam_depth.shape
    mask = (beam_depth > 1e-3) & (beam_depth < 80) & garg_crop_mask(gh, gw)
    if mask.sum() == 0:
        return pred_depth
    ratio = np.median(beam_depth[mask]) / np.median(pred_depth[mask])
    return pred_depth * ratio


def correct_depth(depth: np.ndarray, beams: np.ndarray, calib: Calibration,
                  device: torch.device, consider_range=(-0.1, 4.0),
                  cap_pl: int = 32768, cap_l: int = 8192):
    """GDC of a native-resolution metric depth map against the K-beam
    depth map `beams` (0 where there is no return) on `device`; returns
    (corrected (H, W) float32 numpy, info)."""
    gtd = beams.copy()
    gtd[gtd == 0] = -1
    corrected, info = gdc_correct(
        torch.as_tensor(depth.astype(np.float32), device=device),
        torch.as_tensor(gtd.astype(np.float32), device=device),
        GDCCalib.from_calibration(calib), k=10, W_tol=3e-5, recon_tol=5e-4,
        consider_range=consider_range, cap_pl=cap_pl, cap_l=cap_l,
        return_info=True)
    return corrected.cpu().numpy(), info


def gdc_one_frame(cfg: Config, data_path: str, folder: str, idx: int,
                  side: str, calib: Optional[Calibration] = None,
                  cap_pl: int = 32768, cap_l: int = 8192,
                  device=None) -> np.ndarray:
    """Full per-frame correction; returns the depth map that gets cached."""
    device = resolve_device(device)
    date = folder.split("/")[0]
    if calib is None:
        calib = Calibration.from_file(
            os.path.join(data_path, date, "calib_cam_to_cam.txt"))

    if cfg.random_sample > 0:
        beam_dir, depth_dir = (f"random{cfg.random_sample}",
                               f"inf_depth_r{cfg.random_sample}")
        consider_range = (-1.5, 9.0)
    else:
        beam_dir, depth_dir = (f"{cfg.nbeams}beam",
                               f"inf_depth_{cfg.nbeams}beam")
        consider_range = (-0.1, 4.0)

    beam_bin = os.path.join(data_path, folder, beam_dir, f"{idx:010d}.bin")
    side_cam = {"l": 2, "r": 3}[side]
    beams = generate_depth_map(
        os.path.join(data_path, date), beam_bin, side_cam, vel_depth=True)

    disp = np.load(os.path.join(
        data_path, folder, depth_dir, f"{idx}_{side}.npy"))[0][0]
    scaled_disp, _ = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
    gh, gw = beams.shape
    scaled_disp = resize_linear_np(np.asarray(scaled_disp), gh, gw)
    pred_depth = 1.0 / scaled_disp

    pred_depth = median_scale_to_beams(pred_depth, beams)

    corrected, info = correct_depth(pred_depth, beams, calib, device,
                                    consider_range, cap_pl, cap_l)
    if info["overflow"]:
        print(f"WARNING: GDC capacity overflow for {folder} {idx} {side}: "
              f"n_pl={info['n_pl']}/{cap_pl} n_l={info['n_l']}/{cap_l} — "
              "points beyond capacity were dropped; raise cap_pl/cap_l",
              flush=True)
    if not np.isfinite(corrected).all():
        print(f"GDC failed for {folder} {idx} {side}; keeping uncorrected")
        corrected = pred_depth
    return corrected


def run_inf_gdc(cfg: Config, lines: Sequence[str],
                data_path: Optional[str] = None,
                cap_pl: int = 32768, cap_l: int = 8192,
                device=None) -> int:
    """Process every `folder idx side` line; returns frames written. Runs
    on cuda:0 unless `device` names another (device="cpu" for the
    tests)."""
    device = resolve_device(device)
    data_path = data_path or cfg.data_path
    n = 0
    calib_cache = {}
    for line in lines:
        folder, idx, side = line.split()
        idx = int(idx)
        date = folder.split("/")[0]
        if date not in calib_cache:
            calib_cache[date] = Calibration.from_file(
                os.path.join(data_path, date, "calib_cam_to_cam.txt"))
        depth = gdc_one_frame(cfg, data_path, folder, idx, side,
                              calib_cache[date], cap_pl=cap_pl,
                              cap_l=cap_l, device=device)
        if cfg.random_sample > 0:
            out_dir = os.path.join(data_path, folder,
                                   f"inf_gdc_r{cfg.random_sample}")
        else:
            out_dir = os.path.join(data_path, folder,
                                   f"inf_gdc_{cfg.nbeams}beam")
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{idx}_{side}.npy"),
                depth.astype(np.float32))
        n += 1
    return n
