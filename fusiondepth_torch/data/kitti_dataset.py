"""KITTI dataset implementations over the MonoDataset contract.

Storage layouts and conventions match the reference loaders
(datasets/kitti_dataset.py:28-335): raw-KITTI folder structure, side_map
2/3 <-> l/r, normalized intrinsics, 4-beam bins projected at (384, 1280)
then 2x2 max-pooled, precomputed 2channel / inf_depth / inf_gdc .npy caches.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from fusiondepth_torch.data.kitti_io import generate_depth_map
from fusiondepth_torch.data.mono_dataset import MonoDataset, pil_loader
from fusiondepth_torch.data.two_channel import max_pool2
from fusiondepth_torch.ops.resize import resize_linear_np

SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}

# KITTI-raw capture dates keyed by native image shape — used by the
# detection split, whose frames don't carry their capture date
# (reference kitti_dataset.py:13-25)
DETEC_CALIB_BY_SHAPE = {
    (375, 1242): "2011_09_26",
    (370, 1224): "2011_09_28",
    (374, 1238): "2011_09_29",
    (370, 1226): "2011_09_30",
    (376, 1241): "2011_10_03",
}

NORMALIZED_K = np.array(
    [[0.58, 0, 0.5, 0],
     [0, 1.92, 0.5, 0],
     [0, 0, 1, 0],
     [0, 0, 0, 1]], dtype=np.float32)


class KITTIDataset(MonoDataset):
    K = NORMALIZED_K
    full_res_shape = (1242, 375)

    def beam_folder(self) -> str:
        if self.cfg.random_sample > 0:
            return f"random{self.cfg.random_sample}"
        return f"{self.cfg.nbeams}beam"

    def two_channel_folder(self) -> str:
        if self.cfg.random_sample > 0:
            return f"r{self.cfg.random_sample}_2cha"
        if self.cfg.nbeams == 4:
            return "2channel"
        return f"2channel{self.cfg.nbeams}beam"

    def frame_str(self, frame_index: int) -> str:
        return f"{int(frame_index):010d}"

    def calib_dir(self, folder: str, frame_index) -> str:
        return os.path.join(self.data_path, folder.split("/")[0])

    def get_image_path(self, folder, frame_index, side) -> str:
        return os.path.join(
            self.data_path, folder, f"image_0{SIDE_MAP[side]}/data",
            self.frame_str(frame_index) + self.img_ext)

    def check_depth(self) -> bool:
        if not self.filenames:
            return False
        folder, frame_index, _ = self.parse_line(0)
        return os.path.isfile(os.path.join(
            self.data_path, folder, "velodyne_points/data",
            self.frame_str(frame_index) + ".bin"))

    def get_color(self, folder, frame_index, side, do_flip):
        img = pil_loader(self.get_image_path(folder, frame_index, side))
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def get_depth(self, folder, frame_index, side, do_flip):
        velo = os.path.join(self.data_path, folder, "velodyne_points/data",
                            self.frame_str(frame_index) + ".bin")
        depth = generate_depth_map(self.calib_dir(folder, frame_index), velo,
                                   SIDE_MAP[side], shape=(375, 1242))
        if do_flip:
            depth = np.fliplr(depth)
        return depth

    def get_4beam(self, folder, frame_index, side, do_flip):
        """Project the K-beam bin at 2x the network resolution then 2x2
        max-pool down (reference kitti_dataset.py:93-117 — exactly
        (384, 1280) -> (192, 640) at the default size)."""
        velo = os.path.join(self.data_path, folder, self.beam_folder(),
                            self.frame_str(frame_index) + ".bin")
        depth = generate_depth_map(self.calib_dir(folder, frame_index), velo,
                                   SIDE_MAP[side],
                                   shape=(2 * self.height, 2 * self.width))
        depth = max_pool2(depth)
        if do_flip:
            depth = np.fliplr(depth)
        return depth

    def get_4beam_full(self, folder, frame_index, side, do_flip):
        """Native-resolution (375, 1242) projection of the K-beam bin.
        Deliberately NOT flipped under do_flip — the reference never flips
        the full-res copy (reference kitti_dataset.py:112-117)."""
        velo = os.path.join(self.data_path, folder, self.beam_folder(),
                            self.frame_str(frame_index) + ".bin")
        return generate_depth_map(self.calib_dir(folder, frame_index), velo,
                                  SIDE_MAP[side], shape=(375, 1242))

    def load_4beam_2channel(self, folder, frame_index, side, do_flip):
        path = os.path.join(
            self.data_path, folder, self.two_channel_folder(),
            f"{int(frame_index)}_{side}_{do_flip}.npy")
        arr = np.load(path).astype(np.float32)
        # caches may be stored channel-first (2, H, W); contract is NHWC
        if arr.shape[0] == 2 and arr.ndim == 3:
            arr = np.moveaxis(arr, 0, -1)
        return arr

    def load_pred_depth(self, folder, frame_index, side, do_flip):
        if self.cfg.random_sample > 0:
            sub = f"inf_depth_r{self.cfg.random_sample}"
        else:
            sub = f"inf_depth_{self.cfg.nbeams}beam"
        path = os.path.join(self.data_path, folder, sub,
                            f"{int(frame_index)}_{side}.npy")
        arr = np.load(path).astype(np.float32)
        arr = arr.reshape(arr.shape[-2], arr.shape[-1])
        if do_flip:
            arr = np.fliplr(arr)
        return arr[..., None]

    def load_gdc(self, folder, frame_index, side, do_flip):
        if self.cfg.random_sample > 0:
            sub = f"inf_gdc_r{self.cfg.random_sample}"
        else:
            sub = f"inf_gdc_{self.cfg.nbeams}beam"
        path = os.path.join(self.data_path, folder, sub,
                            f"{int(frame_index)}_{side}.npy")
        gdc = np.load(path).astype(np.float32)
        gdc = resize_linear_np(gdc, self.height, self.width)
        if do_flip:
            gdc = np.fliplr(gdc)
        return gdc[..., None]


class KITTIRAWDataset(KITTIDataset):
    """Raw KITTI with velodyne ground truth (the default trainer dataset)."""


class KITTIOdomDataset(KITTIDataset):
    """KITTI odometry layout (reference kitti_dataset.py:287-301)."""

    def frame_str(self, frame_index: int) -> str:
        return f"{int(frame_index):06d}"

    def get_image_path(self, folder, frame_index, side):
        return os.path.join(
            self.data_path, f"sequences/{int(folder):02d}",
            f"image_{SIDE_MAP[side]}",
            self.frame_str(frame_index) + self.img_ext)


class KITTIDepthDataset(KITTIDataset):
    """KITTI with the official (improved) png ground-truth depth maps."""

    def get_depth(self, folder, frame_index, side, do_flip):
        path = os.path.join(
            self.data_path, folder,
            f"proj_depth/groundtruth/image_0{SIDE_MAP[side]}",
            self.frame_str(frame_index) + ".png")
        img = Image.open(path).resize(self.full_res_shape, Image.NEAREST)
        depth = np.asarray(img).astype(np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class KITTIDetecDataset(KITTIDataset):
    """KITTI 3D-detection split: 6-digit frame ids, capture date resolved by
    native image shape (reference kitti_dataset.py:176-284)."""

    def frame_str(self, frame_index: int) -> str:
        return f"{int(frame_index):06d}"

    def calib_dir(self, folder, frame_index) -> str:
        path = self.get_image_path(folder, frame_index, "l")
        with Image.open(path) as img:
            shape = (img.height, img.width)
        date = DETEC_CALIB_BY_SHAPE.get(shape)
        if date is None:
            raise ValueError(f"unknown KITTI capture shape {shape}")
        return os.path.join(self.data_path, date)

    def beam_folder(self) -> str:
        if self.cfg.random_sample != -1:
            return f"random{self.cfg.random_sample}"
        return "4beam"

    def two_channel_folder(self) -> str:
        if self.cfg.random_sample != -1:
            return f"r{self.cfg.random_sample}_2cha"
        return "2channel"
