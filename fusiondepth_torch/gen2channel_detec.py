"""CLI: 2-channel encoding for the KITTI 3D-detection split on the port
(the JAX package's gen2channel_detec.py; same flags, same files): the
expansion of gen2channel, with 6-digit frame ids and the capture date's
calibration found by the native image shape. Host work only (numpy, PIL):
it needs no card.

    python -m fusiondepth_torch.gen2channel_detec --data_path kitti_data
"""

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split_file", default="splits/detection/test.txt")
    p.add_argument("--data_path", default="kitti_data")
    p.add_argument("--folder", default="kitti_detect/training")
    p.add_argument("--expand", type=int, default=2)
    p.add_argument("--regenerate", action="store_true")
    args = p.parse_args(argv)

    from PIL import Image

    from fusiondepth_torch.data.kitti_dataset import DETEC_CALIB_BY_SHAPE
    from fusiondepth_torch.data.kitti_io import readlines
    from fusiondepth_torch.data.two_channel import sparse_beam_to_2channel

    side_cam = {"l": 2, "r": 3}
    n = 0
    for line in readlines(args.split_file):
        parts = line.split()
        folder = parts[0] if len(parts) > 1 else args.folder
        idx = int(parts[1]) if len(parts) > 1 else int(parts[0])
        side = parts[2] if len(parts) > 2 else "l"
        img_path = os.path.join(args.data_path, folder, "image_02/data",
                                f"{idx:06d}.png")
        with Image.open(img_path) as img:
            shape = (img.height, img.width)
        date = DETEC_CALIB_BY_SHAPE.get(shape)
        if date is None:
            print(f"unknown capture shape {shape} for frame {idx}; skipped")
            continue
        calib_dir = os.path.join(args.data_path, date)
        velo = os.path.join(args.data_path, folder, "4beam",
                            f"{idx:06d}.bin")
        out_dir = os.path.join(args.data_path, folder, "2channel")
        os.makedirs(out_dir, exist_ok=True)
        for flip in (False, True):
            out = os.path.join(out_dir, f"{idx}_{side}_{flip}.npy")
            if os.path.exists(out) and not args.regenerate:
                continue
            two = sparse_beam_to_2channel(calib_dir, velo, side_cam[side],
                                          flip, expand=args.expand)
            np.save(out, two.astype(np.float32))
            n += 1
    print(f"gen2channel_detec: wrote {n} maps")
    return n


if __name__ == "__main__":
    main()
