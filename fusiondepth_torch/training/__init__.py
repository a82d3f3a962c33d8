"""Drivers of the port: photometric loss, train step, trainer, inference
cache, evaluation, checkpoints."""
