"""Depth evaluation protocol: garg/eigen crop, median scaling, flip
post-processing, 7-metric report.

Mirrors reference evaluate_depth.py:42-71,349-488. Per-image GT shapes vary
across KITTI, so the crop/scale/metric step runs as host-side numpy over the
(small) eval set while the network forward is jitted on device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")

# models trained with stereo supervision predict depth up to the KITTI rig's
# 0.1-unit baseline; x5.4 recovers meters (reference evaluate_depth.py:32)
STEREO_SCALE_FACTOR = 5.4


def compute_errors_np(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """The 7 standard metrics over flat valid-pixel arrays."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    return dict(zip(METRIC_NAMES,
                    (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3)))


def garg_crop_mask(gt_height: int, gt_width: int) -> np.ndarray:
    """The eigen evaluation crop (reference evaluate_depth.py:358-365)."""
    mask = np.zeros((gt_height, gt_width), bool)
    mask[int(0.40810811 * gt_height): int(0.99189189 * gt_height),
         int(0.03594771 * gt_width): int(0.96405229 * gt_width)] = True
    return mask


def flip_postprocess(disp_l: np.ndarray, disp_r_flipped: np.ndarray
                     ) -> np.ndarray:
    """Monodepthv1 flip post-processing (reference evaluate_depth.py:63-71):
    blend the disparity of the image and its mirrored twin with a lateral
    ramp mask. Inputs (B, H, W)."""
    B, H, W = disp_l.shape
    mean = 0.5 * (disp_l + disp_r_flipped)
    xs = np.tile(np.linspace(0, 1, W, dtype=disp_l.dtype), (H, 1))
    l_mask = np.clip(20 * (xs - 0.05), 0, 1)[None]
    r_mask = l_mask[:, :, ::-1]
    return (r_mask * disp_l + l_mask * disp_r_flipped
            + (1.0 - l_mask - r_mask) * mean)


def evaluate_one(
    pred_disp: np.ndarray,
    gt_depth: np.ndarray,
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    eval_split: str = "eigen",
    disable_median_scaling: bool = False,
    pred_depth_scale_factor: float = 1.0,
) -> tuple[Dict[str, float], float]:
    """Evaluate one frame (reference evaluate_depth.py:338-488).

    pred_disp: (h, w) network disparity; gt_depth: (H, W) metric GT.
    Returns (metrics, median_ratio).
    """
    import cv2

    gh, gw = gt_depth.shape
    pred_disp_full = cv2.resize(pred_disp.astype(np.float32), (gw, gh))
    pred_depth = 1.0 / np.maximum(pred_disp_full, 1e-12)

    if eval_split == "eigen":
        mask = (gt_depth > min_depth) & (gt_depth < max_depth)
        mask &= garg_crop_mask(gh, gw)
    else:
        mask = gt_depth > 0

    pred = pred_depth[mask] * pred_depth_scale_factor
    gt = gt_depth[mask]

    ratio = 1.0
    if not disable_median_scaling:
        ratio = float(np.median(gt) / np.median(pred))
        pred = pred * ratio

    pred = np.clip(pred, min_depth, max_depth)
    return compute_errors_np(gt, pred), ratio


def evaluate_disparities(pred_disps, gt_depths, **kw) -> Dict[str, float]:
    """Average the 7 metrics over a list of (pred_disp, gt_depth) pairs."""
    rows = []
    ratios = []
    for pred_disp, gt in zip(pred_disps, gt_depths):
        m, r = evaluate_one(pred_disp, gt, **kw)
        rows.append([m[k] for k in METRIC_NAMES])
        ratios.append(r)
    mean = np.array(rows).mean(axis=0)
    out = dict(zip(METRIC_NAMES, mean.tolist()))
    out["med_ratio"] = float(np.median(ratios))
    return out
