"""Drivers of the port: inference cache, evaluation, checkpoints."""
