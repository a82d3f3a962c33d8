"""CLI: 2-channel LiDAR encoding cache on the port (the JAX package's
gen2channel.py; same flags, same files): for each frame and its
horizontal flip, project the sparse beams and expand them to (expanded
depth, confidence), saved as 2channel[{n}beam]/{idx}_{side}_{flip}.npy
(r{N}_2cha/ for random-sample bins). Host work only (numpy,
`data/two_channel.py`): it needs no card.

    python -m fusiondepth_torch.gen2channel \
        --split_file splits/eigen_zhou/train_files.txt \
        --data_path kitti_data --nbeams 4
"""

import argparse
import os

import numpy as np

SIDE_CAM = {"l": 2, "r": 3, "2": 2, "3": 3}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split_file", required=True)
    p.add_argument("--data_path", default="kitti_data")
    p.add_argument("--nbeams", type=int, default=4)
    p.add_argument("--expand", type=int, default=2)
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--regenerate", action="store_true")
    p.add_argument("--random_sample", type=int, default=0,
                   help="encode random-sample bins (random{N}/ -> "
                        "r{N}_2cha/, reference gen2channel.py:18-25)")
    args = p.parse_args(argv)

    from fusiondepth_torch.data.kitti_io import readlines
    from fusiondepth_torch.data.two_channel import sparse_beam_to_2channel

    if args.random_sample > 0:
        in_name = f"random{args.random_sample}"
        out_name = f"r{args.random_sample}_2cha"
    else:
        in_name = f"{args.nbeams}beam"
        out_name = ("2channel" if args.nbeams == 4
                    else f"2channel{args.nbeams}beam")
    n = 0
    for line in readlines(args.split_file):
        folder, idx, side = line.split()
        idx = int(idx)
        calib_dir = os.path.join(args.data_path, folder.split("/")[0])
        velo = os.path.join(args.data_path, folder, in_name,
                            f"{idx:010d}.bin")
        if not os.path.exists(velo):
            continue
        out_dir = os.path.join(args.data_path, folder, out_name)
        os.makedirs(out_dir, exist_ok=True)
        for flip in (False, True):
            out = os.path.join(out_dir, f"{idx}_{side}_{flip}.npy")
            if os.path.exists(out) and not args.regenerate:
                continue
            two = sparse_beam_to_2channel(calib_dir, velo, SIDE_CAM[side],
                                          flip, expand=args.expand)
            np.save(out, two.astype(np.float32))
            n += 1
    print(f"gen2channel: wrote {n} maps")
    return n


if __name__ == "__main__":
    main()
