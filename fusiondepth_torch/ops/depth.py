"""Disparity <-> depth conversion (reference layers.py:11-20)."""

from __future__ import annotations


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Convert a sigmoid disparity in [0, 1] to (scaled_disp, depth), depth
    ranging over [min_depth, max_depth]. Works on tensors and arrays."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth
