"""KITTI depth-completion dataset (352x1216 bottom-crop pipeline): a copy
of the JAX package's `data/completion_dataset.py` (numpy and PIL only),
so that the port runs where JAX is not installed.

Mirrors reference datasets/completion_dataset.py + kitti_completion.py:
glob-based path discovery over the depth-completion layout (train /
val-full / val-select / anonymous test), neighbor-frame verification for
temporal triplets, 16-bit png sparse depth / 256, sparse depth doubling as
the "2channel" input when completion_need2channel is off
(completion_dataset.py:310-325,358-369).

Produces the same batch contract as MonoDataset (color/color_aug stacks,
two_channel, four_beam, K/inv_K, depth_gt).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.kitti_dataset import NORMALIZED_K
from fusiondepth_torch.data.mono_dataset import ColorJitter, pil_loader

CROP_H, CROP_W = 352, 1216


def bottom_crop(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    i = h - CROP_H
    j = int(round((w - CROP_W) / 2.0))
    return img[i: i + CROP_H, j: j + CROP_W]


def discover_paths(data_folder: str, split: str, val_split: str = "select",
                   verify: bool = True) -> Dict[str, List[Optional[str]]]:
    """Path discovery over the official completion layout
    (reference completion_dataset.py:22-139)."""
    if split == "train":
        glob_d = os.path.join(
            data_folder,
            "data_depth_velodyne/train/*_sync/proj_depth/velodyne_raw/"
            "image_0[2,3]/*.png")
        glob_gt = os.path.join(
            data_folder,
            "data_depth_annotated/train/*_sync/proj_depth/groundtruth/"
            "image_0[2,3]/*.png")

        def rgb_of(p):
            ps = p.split("/")
            return "/".join([data_folder, "data_rgb"] + ps[-6:-4]
                            + ps[-2:-1] + ["data"] + ps[-1:])
    elif split == "val" and val_split == "full":
        glob_d = os.path.join(
            data_folder,
            "data_depth_velodyne/val/*_sync/proj_depth/velodyne_raw/"
            "image_0[2,3]/*.png")
        glob_gt = os.path.join(
            data_folder,
            "data_depth_annotated/val/*_sync/proj_depth/groundtruth/"
            "image_0[2,3]/*.png")

        def rgb_of(p):
            ps = p.split("/")
            return "/".join(ps[:-7] + ["data_rgb"] + ps[-6:-4]
                            + ps[-2:-1] + ["data"] + ps[-1:])
    elif split == "val":  # select
        glob_d = os.path.join(
            data_folder, "depth_selection/val_selection_cropped/"
            "velodyne_raw/*.png")
        glob_gt = os.path.join(
            data_folder, "depth_selection/val_selection_cropped/"
            "groundtruth_depth/*.png")

        def rgb_of(p):
            return p.replace("groundtruth_depth", "image")
    elif split == "test_completion":
        glob_d = os.path.join(
            data_folder, "depth_selection/test_depth_completion_anonymous/"
            "velodyne_raw/*.png")
        glob_rgb = os.path.join(
            data_folder, "depth_selection/test_depth_completion_anonymous/"
            "image/*.png")
        paths_rgb = sorted(glob.glob(glob_rgb))
        paths_d = sorted(glob.glob(glob_d))
        return {"rgb": paths_rgb, "d": paths_d,
                "gt": [None] * len(paths_rgb)}
    else:
        raise ValueError(f"unrecognized split {split}")

    paths_d = sorted(glob.glob(glob_d))
    paths_gt = sorted(glob.glob(glob_gt))
    paths_rgb = [rgb_of(p) for p in paths_gt]

    if verify and split == "train":
        def has_neighbors(p):
            head, tail = os.path.split(p)
            n = int(tail[: tail.find(".")])
            return (os.path.isfile(os.path.join(head, f"{n - 1:010d}.png"))
                    and os.path.isfile(
                        os.path.join(head, f"{n + 1:010d}.png")))

        keep = [i for i, p in enumerate(paths_d) if has_neighbors(p)]
        paths_d = [paths_d[i] for i in keep]
        paths_gt = [paths_gt[i] for i in keep]
        paths_rgb = [paths_rgb[i] for i in keep]

    return {"rgb": paths_rgb, "d": paths_d, "gt": paths_gt}


def load_depth_png(path: str) -> np.ndarray:
    """16-bit completion png -> meters (reference kitti_completion.py:51-66)."""
    with Image.open(path) as f:
        depth_png = np.array(f, dtype=np.int32)
    assert depth_png.max() > 255, f"not a 16-bit depth map: {path}"
    return depth_png.astype(np.float32) / 256.0


class KITTICompletion:
    """352x1216 completion dataset following the MonoDataset batch contract."""

    K = NORMALIZED_K

    def __init__(self, data_path: str, height: int = CROP_H,
                 width: int = CROP_W, frame_ids=(0, -1, 1),
                 is_train: bool = False, val_split: str = "select",
                 cfg: Optional[Config] = None, seed: int = 0,
                 paths: Optional[Dict] = None):
        self.data_path = data_path
        self.height = height
        self.width = width
        self.frame_ids = list(frame_ids) if is_train else [0]
        self.is_train = is_train
        self.cfg = cfg or Config()
        self.rng = random.Random(seed)
        split = "train" if is_train else "val"
        if self.cfg.completion_test:
            split = "test_completion"
        self.paths = paths if paths is not None else discover_paths(
            data_path, split, val_split)
        self.load_depth = not self.cfg.completion_test

    def __len__(self) -> int:
        return len(self.paths["rgb"])

    def parse_line(self, index: int):
        p = self.paths["rgb"][index]
        tail = os.path.basename(p)
        return os.path.dirname(p), int(tail[: tail.find(".")]), "l"

    # ---- raw loaders ----

    def _color(self, path: str, do_flip: bool) -> np.ndarray:
        img = pil_loader(path)
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img).astype(np.float32) / 255.0
        if arr.shape[0] != self.height or arr.shape[1] != self.width:
            arr = bottom_crop(arr)
        return arr

    def _depth(self, path: str, do_flip: bool) -> np.ndarray:
        d = load_depth_png(path)
        if do_flip:
            d = np.fliplr(d)
        if d.shape != (self.height, self.width):
            d = bottom_crop(d)
        return d.copy()

    def _two_channel(self, d_path: str, do_flip: bool) -> np.ndarray:
        """Precomputed (gen2cha_completion.py) expansion from the `2cha/`
        sibling of the sparse-depth dir (reference
        kitti_completion.py:82-105), HWC float32."""
        head, tail = os.path.split(d_path)
        npy_path = os.path.join(os.path.dirname(head), "2cha",
                                tail[: tail.find(".")] + ".npy")
        arr = np.load(npy_path).astype(np.float32)
        if arr.shape[0] == 2 and arr.ndim == 3:  # channel-first caches
            arr = np.moveaxis(arr, 0, -1)
        if do_flip:
            arr = arr[:, ::-1]
        if arr.shape[:2] != (self.height, self.width):
            arr = bottom_crop(arr)
        return arr.copy()

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        do_color_aug = self.is_train and self.rng.random() > 0.5
        do_flip = self.is_train and self.rng.random() > 0.5

        rgb_path = self.paths["rgb"][index]
        d_path = self.paths["d"][index]

        colors, sparse_stack = [], []
        if self.is_train:
            head, tail = os.path.split(rgb_path)
            frame_index = int(tail[: tail.find(".")])
            head_d = os.path.dirname(d_path)
            for i in self.frame_ids:
                colors.append(self._color(
                    os.path.join(head, f"{frame_index + i:010d}.png"),
                    do_flip))
                dp = os.path.join(head_d, f"{frame_index + i:010d}.png")
                if cfg.completion_need2channel:
                    # real expanded 2channel cache (reference
                    # completion_dataset.py:317-321)
                    sparse_stack.append(self._two_channel(dp, do_flip))
                else:
                    # default: raw sparse depth stacked twice (reference
                    # completion_dataset.py:322-325,367)
                    sparse = self._depth(dp, do_flip) / 100.0
                    sparse_stack.append(np.stack([sparse, sparse], axis=-1))
        else:
            colors.append(self._color(rgb_path, do_flip))
            if cfg.completion_need2channel:
                sparse_stack.append(self._two_channel(d_path, do_flip))
            else:
                sparse = self._depth(d_path, do_flip) / 100.0
                sparse_stack.append(np.stack([sparse, sparse], axis=-1))

        color = np.stack(colors)
        if do_color_aug:
            jitter = ColorJitter(self.rng)
            color_aug = np.stack([jitter(c.copy()) for c in colors])
        else:
            color_aug = color.copy()

        K = self.K.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height

        sample: Dict[str, np.ndarray] = {
            "color": color,
            "color_aug": color_aug,
            "two_channel": np.stack(sparse_stack).astype(np.float32),
            "K": K.astype(np.float32),
            "inv_K": np.linalg.pinv(K).astype(np.float32),
        }
        if cfg.need_path:
            # rgb path for naming offline caches (reference
            # completion_dataset.py:307-308; collated unstacked)
            sample["path"] = rgb_path

        if cfg.need_4beam:
            fb = self._depth(d_path, do_flip) / 100.0
            sample["four_beam"] = fb.astype(np.float32)[..., None]

        if self.load_depth and self.paths["gt"][index] is not None:
            sample["depth_gt"] = self._depth(
                self.paths["gt"][index], do_flip).astype(np.float32)

        return sample
