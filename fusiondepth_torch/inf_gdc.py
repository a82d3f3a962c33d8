"""CLI: offline GDC correction cache on the port. Corrects every cached
inf_depth frame of the train split and the eigen test split (written by
`python -m fusiondepth_torch.inf_depth_map`) against its K-beam LiDAR,
one frame at a time on cuda:0, and saves inf_gdc_{n}beam caches for the
refiner; same flags as the JAX package's inf_gdc.py.

    python -m fusiondepth_torch.inf_gdc --data_path kitti_data --nbeams 4
"""

import os

from fusiondepth_torch.config import parse_args

SPLIT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splits")


def main(argv=None):
    cfg = parse_args(argv)
    from fusiondepth_torch.data.kitti_io import readlines
    from fusiondepth_torch.training.gdc_driver import run_inf_gdc

    lines = []
    for split_file in (
            os.path.join(SPLIT_DIR, cfg.split, "train_files.txt"),
            os.path.join(SPLIT_DIR, "eigen", "test_files.txt")):
        lines.extend(readlines(split_file))
    n = run_inf_gdc(cfg, lines)
    print(f"inf_gdc: wrote {n} frames")


if __name__ == "__main__":
    main()
