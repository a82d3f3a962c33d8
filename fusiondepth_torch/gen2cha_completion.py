"""CLI: 2-channel encoding for the depth-completion layout on the port
(the JAX package's gen2cha_completion.py; same flags): expand the 352x1216
bottom-cropped velodyne_raw sparse depth into (expanded depth, confidence)
and save <drive>/proj_depth/2cha/{frame}.npy. Window rows [110, 350), cols
[2, 1214) (reference gen2cha_completion.py:54-55). Host work only (numpy,
`data/two_channel.py`), as in the JAX package: it needs no card.

    python -m fusiondepth_torch.gen2cha_completion \
        --data_path kitti_data/completion --split train
"""

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", default="kitti_data/completion")
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--expand", type=int, default=2)
    p.add_argument("--regenerate", action="store_true")
    args = p.parse_args(argv)

    from fusiondepth_torch.data.completion_dataset import (
        bottom_crop,
        load_depth_png,
    )
    from fusiondepth_torch.data.two_channel import expand_two_channel

    pattern = os.path.join(
        args.data_path,
        f"data_depth_velodyne/{args.split}/*_sync/proj_depth/velodyne_raw/"
        "image_0[2,3]/*.png")
    n = 0
    for path in sorted(glob.glob(pattern)):
        head = os.path.dirname(os.path.dirname(path))
        out_dir = os.path.join(head, "2cha")
        os.makedirs(out_dir, exist_ok=True)
        tail = os.path.basename(path)
        out = os.path.join(out_dir, tail[: tail.find(".")] + ".npy")
        if os.path.exists(out) and not args.regenerate:
            continue
        depth = bottom_crop(load_depth_png(path))
        two = expand_two_channel(depth / 100.0, expand=args.expand,
                                 row_range=(110, 350), col_range=(2, 1214))
        np.save(out, two.astype(np.float32))
        n += 1
    print(f"gen2cha_completion: wrote {n} maps")
    return n


if __name__ == "__main__":
    main()
