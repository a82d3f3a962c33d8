"""CLI: bake a split's ground-truth (and K-beam) depth maps on the port
(the JAX package's export_gt_depth.py; same flags, same files):
splits/<split>/gt_depths.npz and, with --export_4beam, 4beam.npz, read by
evaluation and the trainer's val loop. Host work only (numpy,
`data/kitti_io.py`): it needs no card.

    python -m fusiondepth_torch.export_gt_depth --data_path kitti_data \
        --split eigen
"""

import argparse
import os

import numpy as np

SPLITS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splits")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", default="kitti_data")
    p.add_argument("--split", default="eigen")
    p.add_argument("--nbeams", type=int, default=4)
    p.add_argument("--export_4beam", action="store_true")
    args = p.parse_args(argv)

    from fusiondepth_torch.data.kitti_io import generate_depth_map, readlines

    split_dir = os.path.join(SPLITS_DIR, args.split)
    lines = readlines(os.path.join(split_dir, "test_files.txt"))
    side_cam = {"l": 2, "r": 3}
    gt_depths, beam_depths = [], []
    for line in lines:
        folder, idx, side = line.split()
        idx = int(idx)
        calib_dir = os.path.join(args.data_path, folder.split("/")[0])
        velo = os.path.join(args.data_path, folder, "velodyne_points/data",
                            f"{idx:010d}.bin")
        gt_depths.append(generate_depth_map(
            calib_dir, velo, side_cam[side], vel_depth=True
        ).astype(np.float32))
        if args.export_4beam:
            beam = os.path.join(args.data_path, folder,
                                f"{args.nbeams}beam", f"{idx:010d}.bin")
            beam_depths.append(generate_depth_map(
                calib_dir, beam, side_cam[side], vel_depth=True
            ).astype(np.float32))
    np.savez_compressed(os.path.join(split_dir, "gt_depths.npz"),
                        data=np.array(gt_depths, dtype=object))
    if args.export_4beam:
        np.savez_compressed(os.path.join(split_dir, "4beam.npz"),
                            data=np.array(beam_depths, dtype=object))
    print(f"export_gt_depth: {len(gt_depths)} frames -> {split_dir}")
    return len(gt_depths)


if __name__ == "__main__":
    main()
