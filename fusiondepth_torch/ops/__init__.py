"""Tensor ops of the port (NCHW), counterparts of `fusiondepth_tpu/ops`."""
