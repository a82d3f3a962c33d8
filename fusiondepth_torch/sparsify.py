"""CLI: beam sparsifier on the port (the JAX package's sparsify.py; same
flags, same files): downsample 64-beam velodyne scans to K beams (or a
random point subset) and write {nbeams}beam/*.bin (random{N}/*.bin) next
to the data. Host work only (numpy, `data/sparsify.py`): it needs no card.

    python -m fusiondepth_torch.sparsify \
        --split_file splits/eigen_zhou/train_files.txt \
        --data_path kitti_data --nbeams 4
"""

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split_file", required=True)
    p.add_argument("--data_path", default="kitti_data")
    p.add_argument("--output_path", default=None,
                   help="defaults to data_path")
    p.add_argument("--nbeams", type=int, default=4)
    p.add_argument("--H", type=int, default=64)
    p.add_argument("--W", type=int, default=1024)
    p.add_argument("--line_spec", type=int, nargs="*", default=None)
    p.add_argument("--slice", type=int, default=1)
    p.add_argument("--random_sample", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from fusiondepth_torch.data.kitti_io import load_velodyne_points, \
        readlines
    from fusiondepth_torch.data.sparsify import sparsify_beams

    out_root = args.output_path or args.data_path
    rng = np.random.default_rng(args.seed)
    sub = (f"{args.nbeams}beam" if args.random_sample == 0
           else f"random{args.random_sample}")
    n = 0
    for line in readlines(args.split_file):
        parts = line.split()
        folder, idx = parts[0], int(parts[1])
        velo = os.path.join(args.data_path, folder,
                            "velodyne_points/data", f"{idx:010d}.bin")
        if not os.path.exists(velo):
            continue
        sparse = sparsify_beams(
            load_velodyne_points(velo), nbeams=args.nbeams, H=args.H,
            W=args.W, line_spec=args.line_spec, slice_step=args.slice,
            random_sample=args.random_sample, rng=rng)
        out_dir = os.path.join(out_root, folder, sub)
        os.makedirs(out_dir, exist_ok=True)
        sparse.astype(np.float32).tofile(
            os.path.join(out_dir, f"{idx:010d}.bin"))
        n += 1
    print(f"sparsify: wrote {n} scans")
    return n


if __name__ == "__main__":
    main()
