"""FusionDepth in PyTorch for NVIDIA Hopper: the port of `fusiondepth_tpu`.

Same configuration (`fusiondepth_torch.config.Config`, a copy of the JAX
package's), parameter trees (loadable both ways, `models/jax_weights.py`),
batch contract and outputs as the JAX package, which stays as the
reference. Internally NCHW with OIHW weights; the TPU's Pallas kernels are
hand-written CUDA kernels under `kernels/`, built from source at first use.

Layout:
  kernels/   CUDA kernels (csrc/), their plain versions, the builder
  ops/       tensor ops (padding, resize, pooling, depth, pose, geometry,
             planes-layout loss pieces, warp)
  models/    nn.Modules (ResNet encoders, depth and pose decoders,
             FusionNets)
  gdc/       graph-based depth correction (stage 2's offline teacher)
  data/      host data pipeline (KITTI, synthetic, loader, prefetch,
             calibration, a synthetic on-disk KITTI drive)
  training/  photometric loss, train step, trainer, inference and
             evaluation drivers, checkpoints, the GDC driver, the refiner

The entry points (`Trainer`, `Infer`, `predict_disparities`, `Refiner`,
`run_inf_gdc`, `evaluate`, the CLIs) run
on cuda:0 unless the caller passes another device, and raise when there is
no card. This package imports torch and never jax, flax or fusiondepth_tpu.
"""

__version__ = "0.2.0"
