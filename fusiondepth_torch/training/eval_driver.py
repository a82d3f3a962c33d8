"""Eigen-split evaluation driver (reference evaluate_depth.py:74-501), depth
branch only. Counterpart of `fusiondepth_tpu/training/eval_driver.py`:
loads weights, runs the model over the eval split (with the flip
post-process when asked), applies the protocol of
`fusiondepth_tpu/training/evaluation.py` (reused as it is) and prints the
7-metric row. The stage-2 modes (refine_2d, eval_gdc) and the visualize,
per_semantic and benchmark-export outputs are not ported yet and raise.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from fusiondepth_tpu.config import Config
from fusiondepth_tpu.data.loader import DataLoader
from fusiondepth_tpu.training.evaluation import (
    METRIC_NAMES,
    STEREO_SCALE_FACTOR,
    evaluate_disparities,
    flip_postprocess,
)
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.training.infer_driver import (
    build_nets,
    default_device,
    device_batch,
)


def predict_disparities(cfg: Config, dataset,
                        nets: Optional[FusionNets] = None,
                        device: Optional[torch.device] = None):
    """Run the depth branch over `dataset`; returns (disps, gt_depths),
    disps a list of (H, W) arrays. With cfg.post_process each batch runs
    again mirrored and the two are blended (eval_driver.py:61-69)."""
    if nets is None:
        device = torch.device(device) if device else default_device()
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


def _kitti_eval_dataset(cfg: Config):
    from fusiondepth_tpu.data.kitti_dataset import (
        KITTIDepthDataset,
        KITTIRAWDataset,
    )
    from fusiondepth_tpu.data.kitti_io import readlines

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
    unported = [f for f in ("refine_2d", "eval_gdc", "visualize",
                            "per_semantic") if getattr(cfg, f)]
    if cfg.eval_split == "benchmark":
        unported.append("eval_split=benchmark")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to fusiondepth_torch yet; "
            "use the JAX package's evaluate_depth.py")
    if dataset is None:
        dataset = _kitti_eval_dataset(cfg)

    if cfg.ext_disp_to_eval:
        disps = list(np.load(cfg.ext_disp_to_eval, allow_pickle=True))
        gts = [dataset[i]["depth_gt"] for i in range(len(dataset))]
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
