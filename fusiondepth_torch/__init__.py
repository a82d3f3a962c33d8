"""FusionDepth in PyTorch for NVIDIA Hopper: the port of `fusiondepth_tpu`.

Same configuration (`fusiondepth_tpu.config.Config`), parameter trees
(loadable both ways, `models/jax_weights.py`), batch contract and outputs
as the JAX package, which stays as the reference. Internally NCHW with OIHW
weights; the TPU's Pallas kernels are hand-written CUDA kernels under
`kernels/`, built from source at first use.

Layout:
  kernels/   CUDA kernels (csrc/), their plain versions, the builder
  ops/       tensor ops (padding, resize, pooling, depth)
  models/    nn.Modules (ResNet encoders, depth decoder, FusionNets)
  training/  inference and evaluation drivers, checkpoints

This package imports torch and never jax or flax.
"""

__version__ = "0.1.0"
