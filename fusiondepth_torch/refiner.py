"""CLI: stage-2 refine training on the port: distils the offline GDC
caches (`python -m fusiondepth_torch.inf_gdc`) into the refine2d decoder
on top of a frozen stage-1 checkpoint; same flags as the JAX package's
refiner.py. Runs on cuda:0.

    python -m fusiondepth_torch.refiner --data_path kitti_data \
        --batch_size 4 --refine_load_weights_folder <stage-1 weights>
"""

import os

from fusiondepth_torch.config import parse_args

SPLIT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splits")


def main(argv=None):
    cfg = parse_args(argv)
    from fusiondepth_torch.data.kitti_dataset import KITTIRAWDataset
    from fusiondepth_torch.data.kitti_io import readlines
    from fusiondepth_torch.training.refiner_driver import Refiner

    ext = ".png" if cfg.png else ".jpg"
    cfg = cfg.replace(clone_gdc=True, refine_2d=True)
    train = KITTIRAWDataset(
        cfg.data_path,
        readlines(os.path.join(SPLIT_DIR, cfg.split, "train_files.txt")),
        cfg.height, cfg.width, cfg.frame_ids, is_train=True, img_ext=ext,
        cfg=cfg)
    val = KITTIRAWDataset(
        cfg.data_path,
        readlines(os.path.join(SPLIT_DIR, "eigen", "test_files.txt")),
        cfg.height, cfg.width, [0], is_train=False, img_ext=ext, cfg=cfg)
    Refiner(cfg, train, val).train()


if __name__ == "__main__":
    main()
