"""CLI: depth-completion training on the port at 352x1216 (the JAX
package's completor.py; same flags). Runs on cuda:0.

    python -m fusiondepth_torch.completor --data_path kitti_data/completion \
        --completion_num_layers 50 --completion_pose_num_layers 18
"""

from fusiondepth_torch.config import parse_args


def main(argv=None, device=None):
    cfg = parse_args(argv)
    from fusiondepth_torch.data.completion_dataset import KITTICompletion
    from fusiondepth_torch.training.completor import Completor
    from fusiondepth_torch.training.infer_driver import resolve_device

    device = resolve_device(device)
    train = KITTICompletion(cfg.data_path, frame_ids=cfg.frame_ids,
                            is_train=True, val_split=cfg.completion_val,
                            cfg=cfg)
    val = KITTICompletion(cfg.data_path, is_train=False,
                          val_split=cfg.completion_val, cfg=cfg)
    Completor(cfg, train, val, device=device).train()


if __name__ == "__main__":
    main()
