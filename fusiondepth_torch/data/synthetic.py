"""Synthetic in-memory batches following the trainer's batch contract.

Used by unit tests, dry runs, and benchmarks — a stand-in for the KITTI
pipeline with the same keys/shapes/dtypes (see models/fusion.py docstring;
the dict-of-keys contract mirrors reference datasets/mono_dataset.py:109-228).
"""

from __future__ import annotations

import numpy as np

from fusiondepth_torch.config import Config


def kitti_like_intrinsics(height: int, width: int) -> np.ndarray:
    """The normalized KITTI intrinsics of the reference
    (datasets/kitti_dataset.py:36-39), scaled to (height, width)."""
    K = np.array(
        [
            [0.58, 0, 0.5, 0],
            [0, 1.92, 0.5, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
    K[0] *= width
    K[1] *= height
    return K


class SyntheticDataset:
    """In-memory dataset of random-but-plausible samples, following the
    per-sample dict contract of MonoDataset (reference
    datasets/mono_dataset.py:109-228). Lets trainers/dry-runs exercise the
    exact production loader + step path without KITTI on disk."""

    def __init__(self, cfg: Config, length: int = 8, seed: int = 0,
                 height: int | None = None, width: int | None = None):
        batch = make_batch(cfg, batch_size=length, seed=seed,
                           height=height, width=width)
        self.samples = [
            {k: v[i] for k, v in batch.items()} for i in range(length)
        ]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        return self.samples[i]


def make_batch(cfg: Config, batch_size: int = 2, seed: int = 0,
               height: int | None = None, width: int | None = None):
    """Random but well-conditioned batch (values in [0,1], plausible beams)."""
    H = height or cfg.height
    W = width or cfg.width
    F = cfg.num_input_frames
    rng = np.random.default_rng(seed)

    color = rng.uniform(0.0, 1.0, size=(batch_size, F, H, W, 3)).astype(
        np.float32)
    two_channel = np.zeros((batch_size, F, H, W, 2), np.float32)
    # sprinkle sparse "beam" hits: a few rows with depth + confidence
    beam_rows = np.linspace(int(H * 0.55), int(H * 0.95), 4).astype(int)
    four_beam = np.zeros((batch_size, H, W, 1), np.float32)
    for r in beam_rows:
        d = rng.uniform(5.0, 60.0, size=(batch_size, W)).astype(np.float32)
        hit = rng.uniform(size=(batch_size, W)) < 0.3
        four_beam[:, r, :, 0] = np.where(hit, d / 100.0, 0.0)
        two_channel[:, :, r, :, 0] = np.where(hit, d / 100.0, 0.0)[:, None]
        two_channel[:, :, r, :, 1] = np.where(
            hit, 1.0 / (d / 100.0 + 1.0), 0.0)[:, None]

    K = kitti_like_intrinsics(H, W)
    Kb = np.broadcast_to(K, (batch_size, 4, 4)).copy()
    inv_Kb = np.broadcast_to(np.linalg.inv(K), (batch_size, 4, 4)).copy()

    batch = {
        "color": color,
        "color_aug": np.clip(color + rng.normal(0, 0.02, color.shape), 0, 1)
        .astype(np.float32),
        "two_channel": two_channel,
        "four_beam": four_beam,
        "K": Kb.astype(np.float32),
        "inv_K": inv_Kb.astype(np.float32),
    }
    if cfg.use_stereo:
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1
        batch["stereo_T"] = np.broadcast_to(T, (batch_size, 4, 4)).copy()
    return batch
