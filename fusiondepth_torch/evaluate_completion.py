"""CLI: depth-completion evaluation on the port (the JAX package's
evaluate_completion.py; same flags): rmse/mae in mm and irmse/imae in 1/km
over the select or full val split, or with --completion_test a 16-bit PNG
(depth * 256) per frame of the anonymous test set under
{log_dir}/completion_test_export/. Runs on cuda:0.

    python -m fusiondepth_torch.evaluate_completion \
        --data_path kitti_data/completion --load_weights_folder <weights>
"""

from fusiondepth_torch.config import parse_args


def main(argv=None, device=None):
    cfg = parse_args(argv)
    import os

    import numpy as np
    from PIL import Image

    from fusiondepth_torch.data.completion_dataset import KITTICompletion
    from fusiondepth_torch.data.loader import DataLoader
    from fusiondepth_torch.training.completor import Completor
    from fusiondepth_torch.training.infer_driver import resolve_device

    device = resolve_device(device)
    if not cfg.completion_not_full_res:
        cfg = cfg.replace(height=352, width=1216)
    dataset = KITTICompletion(cfg.data_path, is_train=False,
                              val_split=cfg.completion_val, cfg=cfg)
    comp = Completor(cfg, None, dataset, device=device)
    if cfg.load_weights_folder and os.path.isdir(cfg.load_weights_folder):
        comp.load(cfg.load_weights_folder)

    if cfg.completion_test:
        out_dir = os.path.join(cfg.log_dir, "completion_test_export")
        os.makedirs(out_dir, exist_ok=True)
        idx = 0
        for batch in DataLoader(dataset, cfg.eval_batch_size):
            for d in comp.predict_depth(batch):
                png = np.clip(d * 256.0, 0, 65535).astype(np.uint16)
                Image.fromarray(png).save(
                    os.path.join(out_dir, f"{idx:010d}.png"))
                idx += 1
        print(f"exported {idx} test depth maps -> {out_dir}")
        return None

    metrics = comp.validate()
    print("  rmse(mm)     mae(mm)   irmse(1/km)  imae(1/km)")
    print("  {rmse:9.2f} {mae:9.2f} {irmse:11.3f} {imae:11.3f}".format(
        **metrics))
    return metrics


if __name__ == "__main__":
    main()
