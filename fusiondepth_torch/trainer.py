"""CLI: stage-1 self-supervised training on the port, same flags as the
JAX package's trainer.py. Runs on cuda:0.

    python -m fusiondepth_torch.trainer --num_layers 18 --height 192 \
        --width 640 --batch_size 12 --data_path kitti_data
"""

from fusiondepth_torch.config import parse_args


def main(argv=None):
    cfg = parse_args(argv)
    from fusiondepth_torch.training.trainer import Trainer

    Trainer(cfg).train()


if __name__ == "__main__":
    main()
