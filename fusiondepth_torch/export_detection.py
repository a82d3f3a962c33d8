"""CLI: depth-map export for monocular 3D detection on the port (the JAX
package's export_detection.py; same flags): run the stage-1 model over
the KITTI 3D-detection split (splits/detection/test.txt), median-scale to
the ground truth where there is one, optionally GDC-correct (--eval_gdc),
and write uint16 depth PNGs (depth * 256) under
<data_path>/kitti_detect/training/<model_name>/. Runs on cuda:0; the
disparity is resized with `ops/resize.py::resize_linear_np` (OpenCV's
INTER_LINEAR).

    python -m fusiondepth_torch.export_detection --data_path kitti_data \
        --load_weights_folder <weights> --model_name <det_name>
"""

import os

from fusiondepth_torch.config import parse_args

SPLIT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splits")


def main(argv=None, device=None):
    cfg = parse_args(argv)
    import numpy as np
    import torch
    from PIL import Image

    from fusiondepth_torch.data.calibration import Calibration
    from fusiondepth_torch.data.kitti_dataset import KITTIDetecDataset
    from fusiondepth_torch.data.kitti_io import readlines
    from fusiondepth_torch.gdc.gdc import GDCCalib, gdc_correct
    from fusiondepth_torch.ops.depth import disp_to_depth
    from fusiondepth_torch.ops.resize import resize_linear_np
    from fusiondepth_torch.training.eval_driver import predict_disparities
    from fusiondepth_torch.training.infer_driver import resolve_device

    device = resolve_device(device)
    files = readlines(os.path.join(SPLIT_DIR, "detection", "test.txt"))
    ext = ".png" if cfg.png else ".jpg"
    dataset = KITTIDetecDataset(cfg.data_path, files, cfg.height, cfg.width,
                                [0], is_train=False, img_ext=ext, cfg=cfg)
    disps, gts = predict_disparities(cfg, dataset, device=device)

    out_root = os.path.join(cfg.data_path, "kitti_detect", "training",
                            cfg.model_name)
    os.makedirs(out_root, exist_ok=True)
    n = 0
    for i, disp in enumerate(disps):
        gt = gts[i] if i < len(gts) else None
        gh, gw = (gt.shape if gt is not None else (375, 1242))
        scaled_disp, _ = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        depth = 1.0 / resize_linear_np(np.asarray(scaled_disp), gh, gw)
        if gt is not None:
            mask = (gt > 1e-3) & (gt < 80)
            if mask.sum() > 0:
                depth *= np.median(gt[mask]) / np.median(depth[mask])
        if cfg.eval_gdc and gt is not None:
            folder, idx, _ = dataset.parse_line(i)
            calib = Calibration.from_file(os.path.join(
                dataset.calib_dir(folder, idx), "calib_cam_to_cam.txt"))
            beams = np.where(gt > 0, gt, -1.0)
            corrected = gdc_correct(
                torch.as_tensor(depth.astype(np.float32), device=device),
                torch.as_tensor(beams.astype(np.float32), device=device),
                GDCCalib.from_calibration(calib)).cpu().numpy()
            if np.isfinite(corrected).all():
                depth = corrected

        png = np.clip(depth * 256.0, 0, 65535).astype(np.uint16)
        Image.fromarray(png).save(os.path.join(out_root, f"{i:06d}.png"))
        n += 1
    print(f"export_detection: wrote {n} depth maps -> {out_root}")
    return n


if __name__ == "__main__":
    main()
