"""CLI: stage-1 self-supervised training on the port, same flags as the
JAX package's trainer.py. Runs on cuda:0, or data-parallel with one
process per card:

    python -m fusiondepth_torch.trainer --num_layers 18 --height 192 \
        --width 640 --batch_size 12 --data_path kitti_data
    torchrun --nproc_per_node 4 -m fusiondepth_torch.trainer --use_mesh \
        --batch_size 12 ...
    python -m fusiondepth_torch.trainer --use_mesh --num_processes 4 \
        --process_id R --coordinator_address host:port ...   (each rank)

--batch_size is the global batch; each process loads its share.
"""

from fusiondepth_torch.config import parse_args


def main(argv=None):
    cfg = parse_args(argv)
    # the process group must be up before the Trainer picks its card
    # (--coordinator_address/--num_processes, or torchrun's variables;
    # parallel/multihost.py)
    import torch.distributed as dist

    from fusiondepth_torch.parallel import maybe_initialize_distributed

    joined = maybe_initialize_distributed(cfg)
    from fusiondepth_torch.training.trainer import Trainer

    try:
        Trainer(cfg).train()
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
