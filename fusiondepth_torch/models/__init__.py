"""nn.Modules of the port, counterparts of `fusiondepth_tpu/models`."""
