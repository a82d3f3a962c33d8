"""CLI: offline depth-map inference cache on the port. Runs the frozen
stage-1 model over the train split and the eigen test split and saves raw
scale-0 disparities for GDC and the refiner; same flags as the JAX
package's inf_depth_map.py.

    python -m fusiondepth_torch.inf_depth_map --num_layers 18 \
        --data_path kitti_data --load_weights_folder <weights folder>
"""

import os

from fusiondepth_tpu.config import parse_args

SPLIT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splits")


def main(argv=None):
    cfg = parse_args(argv)
    from fusiondepth_tpu.data.kitti_dataset import KITTIRAWDataset
    from fusiondepth_tpu.data.kitti_io import readlines
    from fusiondepth_torch.training.infer_driver import Infer

    ext = ".png" if cfg.png else ".jpg"
    datasets = [
        KITTIRAWDataset(cfg.data_path, readlines(split_file), cfg.height,
                        cfg.width, [0], is_train=False, img_ext=ext, cfg=cfg)
        for split_file in (
            os.path.join(SPLIT_DIR, cfg.split, "train_files.txt"),
            os.path.join(SPLIT_DIR, "eigen", "test_files.txt"))]
    Infer(cfg, datasets).run()


if __name__ == "__main__":
    main()
