"""Eigen-split evaluation driver (reference evaluate_depth.py:74-501).
Counterpart of `fusiondepth_tpu/training/eval_driver.py`: loads weights,
runs the model over the eval split (the stage-1 depth branch, or with
refine_2d the stage-2 refine pipeline; with the flip post-process when
asked), optionally runs GDC on each predicted frame (eval_gdc), applies
the protocol of `training/evaluation.py` (a copy of the JAX package's)
and prints the 7-metric row. Its outputs besides the metrics, as in the
JAX package: MAGMA-colormapped disparity PNGs (visualize), a per-class
breakdown over externally made segmentation masks (per_semantic), and,
for eval_split="benchmark" (the KITTI benchmark's test set, which has no
public ground truth), uint16 depth PNGs at 1216x352 instead of metrics.
These are host work on the predicted disparities, with OpenCV as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.training.evaluation import (
    METRIC_NAMES,
    STEREO_SCALE_FACTOR,
    compute_errors_np,
    evaluate_disparities,
    flip_postprocess,
    garg_crop_mask,
)
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.training.infer_driver import (
    build_nets,
    device_batch,
    resolve_device,
)


def predict_disparities(cfg: Config, dataset,
                        nets: Optional[FusionNets] = None,
                        device: Optional[torch.device] = None):
    """Run the depth branch over `dataset`; returns (disps, gt_depths),
    disps a list of (H, W) arrays. With cfg.post_process each batch runs
    again mirrored and the two are blended (eval_driver.py:61-69)."""
    if nets is None:
        device = resolve_device(device)
        if not (cfg.load_weights_folder
                and os.path.exists(cfg.load_weights_folder)):
            print(f"WARNING: load_weights_folder {cfg.load_weights_folder!r}"
                  " not found — evaluating random init")
        nets = build_nets(cfg, device)

    @torch.inference_mode()
    def infer(b):
        out = nets.forward_depth(b, train=False)[0][("disp", 0)]
        return out[..., 0].cpu().numpy()

    loader = DataLoader(dataset, cfg.eval_batch_size, shuffle=False)
    disps, gts = [], []
    for batch in loader:
        db = device_batch(batch, nets.device)
        disp = infer(db)
        if cfg.post_process:
            # every input is an NHWC image: W is the second axis from the end
            flipped = {k: torch.flip(v, dims=(-2,)) for k, v in db.items()}
            disp = flip_postprocess(disp, infer(flipped)[:, :, ::-1])
        disps.extend(disp)
        gts.extend(batch.get("depth_gt", []))
    return disps, gts


def predict_refined_disparities(cfg: Config, dataset, device=None):
    """Stage-2 (refine2d) inference for evaluation (reference
    evaluate_depth.py:197-233): frozen stage-1 forward, pseudo-3D maps,
    refine decoder. The stage-1 weights come from
    cfg.refine_load_weights_folder, the refine weights from
    cfg.load_weights_folder (a folder written by `Refiner.save`). With
    cfg.post_process the mirrored batch goes through the whole refine
    pipeline too (reference evaluate_depth.py:168-170, 240-242)."""
    from fusiondepth_torch.training.refiner_driver import INFER_KEYS, \
        Refiner

    refiner = Refiner(cfg, device=device)
    if cfg.load_weights_folder and os.path.exists(cfg.load_weights_folder):
        refiner.load(cfg.load_weights_folder)
    else:
        print(f"WARNING: load_weights_folder {cfg.load_weights_folder!r} "
              "not found — evaluating the random refine init")
    loader = DataLoader(dataset, cfg.eval_batch_size, shuffle=False)
    disps, gts = [], []
    for batch in loader:
        db = device_batch(batch, refiner.device, INFER_KEYS, refiner.dtype)
        disp = refiner.infer(db)[..., 0].cpu().numpy()
        if cfg.post_process:
            # every input but K is an NHWC image: W is axis -2
            flipped = {k: (v if k == "K" else torch.flip(v, dims=(-2,)))
                       for k, v in db.items()}
            disp_f = refiner.infer(flipped)[..., 0].cpu().numpy()
            disp = flip_postprocess(disp, disp_f[:, :, ::-1])
        disps.extend(disp)
        gts.extend(batch.get("depth_gt", []))
    return disps, gts


def gdc_on_disparities(cfg: Config, dataset, disps, device=None):
    """Online GDC at evaluation (reference evaluate_depth.py:387-405): per
    frame, median-scale the predicted depth to the K-beam LiDAR inside the
    eigen crop, run GDC with the frame's calibration on the card, and
    convert back to disparity at the prediction's size. A frame whose
    correction is not finite keeps its prediction (the reference's bare
    try/except)."""
    from fusiondepth_torch.data.calibration import Calibration
    from fusiondepth_torch.data.kitti_io import generate_depth_map
    from fusiondepth_torch.ops.resize import resize_linear_np
    from fusiondepth_torch.training.gdc_driver import correct_depth, \
        median_scale_to_beams

    device = resolve_device(device)
    out = []
    calib_cache = {}
    for i, disp in enumerate(disps):
        folder, idx, side = dataset.parse_line(i)
        date = folder.split("/")[0]
        if date not in calib_cache:
            calib_cache[date] = Calibration.from_file(os.path.join(
                cfg.data_path, date, "calib_cam_to_cam.txt"))
        beam_bin = os.path.join(cfg.data_path, folder,
                                dataset.beam_folder(),
                                dataset.frame_str(idx) + ".bin")
        side_cam = {"l": 2, "r": 3}[side]
        beams = generate_depth_map(os.path.join(cfg.data_path, date),
                                   beam_bin, side_cam, vel_depth=True)
        gh, gw = beams.shape
        d = np.asarray(disp, np.float32)
        depth = 1.0 / np.maximum(resize_linear_np(d, gh, gw), 1e-12)
        depth = median_scale_to_beams(depth, beams)
        corrected, info = correct_depth(depth, beams, calib_cache[date],
                                        device)
        if info["overflow"]:
            print(f"WARNING: GDC capacity overflow at frame {i}: "
                  f"n_pl={info['n_pl']} n_l={info['n_l']} — points beyond "
                  "capacity were dropped", flush=True)
        if not np.isfinite(corrected).all():
            print(f"GDC failed at frame {i}; keeping uncorrected")
            out.append(disp)
        else:
            out.append(resize_linear_np(1.0 / np.maximum(corrected, 1e-6),
                                        d.shape[0], d.shape[1]))
    return out


def save_visualizations(cfg: Config, disps, out_dir: str) -> None:
    """Colormapped disparity dumps (reference evaluate_depth.py:407-449's
    magma rendering, minus the wandb/open3d hooks):
    {i}{vis_name}depth.png, each disparity over its 95th percentile."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for i, disp in enumerate(disps):
        d = np.asarray(disp, np.float32)
        vmax = np.percentile(d, 95)
        norm = np.clip(d / max(vmax, 1e-9), 0, 1)
        img = cv2.applyColorMap((norm * 255).astype(np.uint8),
                                cv2.COLORMAP_MAGMA)
        cv2.imwrite(os.path.join(out_dir, f"{i}{cfg.vis_name}depth.png"),
                    img, [cv2.IMWRITE_PNG_COMPRESSION, 0])


SEMANTIC_CLASSES = 34


def evaluate_per_semantic(cfg: Config, disps, gts) -> Optional[np.ndarray]:
    """Per-semantic-class metric breakdown (reference
    evaluate_depth.py:451-467) over the masks pred_mask{i}.png under
    cfg.semantic_mask_path (made by an external segmentation model):
    each frame median-scaled inside the eigen crop, then the 7 metrics
    per class, averaged over the frames weighted by the class's pixels.
    Returns (SEMANTIC_CLASSES, 7), or None without the mask folder."""
    import cv2

    if not os.path.isdir(cfg.semantic_mask_path):
        print(f"per_semantic: mask dir {cfg.semantic_mask_path!r} missing")
        return None
    rows = np.zeros((SEMANTIC_CLASSES, len(disps), 7))
    counts = np.zeros((SEMANTIC_CLASSES, len(disps)))
    for i, (disp, gt) in enumerate(zip(disps, gts)):
        gh, gw = gt.shape
        pred = 1.0 / np.maximum(
            cv2.resize(np.asarray(disp, np.float32), (gw, gh)), 1e-12)
        mask = (gt > 1e-3) & (gt < 80) & garg_crop_mask(gh, gw)
        if mask.sum():
            pred = pred * (np.median(gt[mask]) / np.median(pred[mask]))
        sem = np.asarray(Image.open(os.path.join(
            cfg.semantic_mask_path, f"pred_mask{i}.png")))
        for sid in range(SEMANTIC_CLASSES):
            m = mask & (sem == sid)
            counts[sid, i] = m.sum()
            if counts[sid, i] > 0:
                p = np.clip(pred[m], 1e-3, 80)
                rows[sid, i] = list(compute_errors_np(gt[m], p).values())
    weights = counts / np.maximum(counts.sum(1, keepdims=True), 1)
    per_class = (rows * weights[..., None]).sum(1)
    for sid in range(SEMANTIC_CLASSES):
        if counts[sid].sum() > 0:
            print(f"  class {sid:2d}: absrel {per_class[sid, 0]:.3f} "
                  f"({int(counts[sid].sum())} px)")
    return per_class


def save_benchmark_predictions(cfg: Config, disps) -> str:
    """uint16 depth PNGs (depth * 256, the disparity resized to 1216x352
    and scaled by STEREO_SCALE_FACTOR, capped at 80 m) under
    <log_dir>/benchmark_predictions/{idx:010d}.png (reference
    evaluate_depth.py:291-305). Returns the folder."""
    import cv2

    save_dir = os.path.join(cfg.log_dir, "benchmark_predictions")
    os.makedirs(save_dir, exist_ok=True)
    for idx, disp in enumerate(disps):
        d = cv2.resize(np.asarray(disp, np.float32), (1216, 352))
        depth = np.clip(STEREO_SCALE_FACTOR / np.maximum(d, 1e-9), 0, 80)
        cv2.imwrite(os.path.join(save_dir, f"{idx:010d}.png"),
                    np.uint16(depth * 256))
    return save_dir


def _kitti_eval_dataset(cfg: Config):
    from fusiondepth_torch.data.kitti_dataset import (
        KITTIDepthDataset,
        KITTIRAWDataset,
    )
    from fusiondepth_torch.data.kitti_io import readlines

    split_dir = os.path.join(os.path.dirname(__file__), "..", "..", "splits")
    if cfg.demo:
        files = readlines(os.path.join(split_dir, "demo", "demo.txt"))
    else:
        files = readlines(os.path.join(split_dir, cfg.eval_split,
                                       "test_files.txt"))
    cls = (KITTIDepthDataset if cfg.eval_split == "eigen_benchmark"
           else KITTIRAWDataset)
    return cls(cfg.data_path, files, cfg.height, cfg.width, [0],
               is_train=False, img_ext=".png" if cfg.png else ".jpg",
               cfg=cfg)


def evaluate(cfg: Config, dataset=None, device=None):
    """The evaluation of `evaluate_depth.py` over `dataset` (default: the
    split's test_files.txt under splits/; splits/benchmark/ is the user's
    own, as in the JAX package). Returns the metrics, or None with no_eval
    or eval_split="benchmark"."""
    if dataset is None:
        dataset = _kitti_eval_dataset(cfg)

    if cfg.ext_disp_to_eval:
        disps = list(np.load(cfg.ext_disp_to_eval, allow_pickle=True))
        gts = [dataset[i]["depth_gt"] for i in range(len(dataset))]
    elif cfg.refine_2d:
        disps, gts = predict_refined_disparities(cfg, dataset, device=device)
    else:
        disps, gts = predict_disparities(cfg, dataset, device=device)

    if cfg.save_pred_disps:
        out = os.path.join(cfg.log_dir, f"disps_{cfg.eval_split}_split.npy")
        os.makedirs(cfg.log_dir, exist_ok=True)
        np.save(out, np.array([np.asarray(d) for d in disps], dtype=object),
                allow_pickle=True)
        print(f"saved predicted disparities -> {out}")

    if cfg.no_eval:
        print("-> Evaluation disabled. Done.")
        return None

    if cfg.eval_split == "benchmark":
        save_dir = save_benchmark_predictions(cfg, disps)
        print(f"-> Saved benchmark predictions to {save_dir}; "
              "no ground truth available, not evaluating.")
        return None

    if cfg.visualize:
        save_visualizations(cfg, disps,
                            os.path.join(cfg.log_dir, "visualization"))

    if cfg.per_semantic:
        evaluate_per_semantic(cfg, disps, gts)

    if cfg.eval_gdc:
        disps = gdc_on_disparities(cfg, dataset, disps, device=device)

    if cfg.eval_stereo:
        print("   Stereo evaluation - disabling median scaling, "
              f"scaling by {STEREO_SCALE_FACTOR}")
        cfg = cfg.replace(disable_median_scaling=True,
                          pred_depth_scale_factor=STEREO_SCALE_FACTOR)

    metrics = evaluate_disparities(
        disps, gts,
        disable_median_scaling=cfg.disable_median_scaling,
        pred_depth_scale_factor=cfg.pred_depth_scale_factor,
        eval_split=cfg.eval_split)
    print("  " + ("{:>11} " * 7).format(*METRIC_NAMES))
    print("  " + ("{:11.3f} " * 7).format(
        *[metrics[k] for k in METRIC_NAMES]))
    return metrics
