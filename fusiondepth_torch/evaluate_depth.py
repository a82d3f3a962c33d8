"""CLI: eigen-split depth evaluation on the port: load weights, run the
depth branch over the eigen test split, apply the garg-crop /
median-scaling protocol, print the 7-metric row; same flags as the JAX
package's evaluate_depth.py.

    python -m fusiondepth_torch.evaluate_depth --eval_mono --num_layers 18 \
        --data_path kitti_data --load_weights_folder <weights folder>
"""

from fusiondepth_tpu.config import parse_args


def main(argv=None):
    cfg = parse_args(argv)
    # exactly one of --eval_mono / --eval_stereo (reference
    # evaluate_depth.py:81-83)
    if sum((cfg.eval_mono, cfg.eval_stereo)) != 1:
        raise SystemExit("Please choose mono or stereo evaluation by setting "
                         "either --eval_mono or --eval_stereo")
    from fusiondepth_torch.training.eval_driver import evaluate

    evaluate(cfg)


if __name__ == "__main__":
    main()
