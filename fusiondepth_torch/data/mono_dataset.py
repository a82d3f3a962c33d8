"""Base monocular dataset: produces per-sample dicts for the trainer.

Re-designed contract (vs reference datasets/mono_dataset.py:109-228): one
full-resolution color stack per sample — the multi-scale pyramid is built
*inside* the jitted train step on device (training/photometric.py), so the
host only decodes, resizes to (H, W), augments, and stacks:

  color        (F, H, W, 3) float32 in [0, 1], frames in frame_ids order
  color_aug    (F, H, W, 3) same jitter for all frames of one sample
  two_channel  (F, H, W, 2)
  four_beam    (H, W, 1)    K-beam sparse depth / 100
  four_beam_full / two_channel_full — native-res copies when
               cfg.need_full_res_4beam (reference mono_dataset.py:195-211)
  K, inv_K     (4, 4)       full-resolution intrinsics
  stereo_T     (4, 4)       when "s" in frame_ids
  inf_gdc      (H, W, 1)    cached GDC output (refiner distillation)
  depth_gt     (gh, gw)     native-resolution GT (not stacked — eval only)

Augmentation matches the reference policy: 50% color jitter with
brightness/contrast/saturation in (0.8, 1.2), hue in (-0.1, 0.1) applied in
random order, 50% horizontal flip (mono_dataset.py:135-136,85-104).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from fusiondepth_torch.config import Config


def pil_loader(path: str) -> Image.Image:
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


def _rgb_to_hsv_hue_shift(arr: np.ndarray, shift: float) -> np.ndarray:
    """Shift hue of a float [0,1] RGB array by `shift` (fraction of a turn)."""
    img = Image.fromarray((arr * 255).astype(np.uint8), "RGB").convert("HSV")
    hsv = np.array(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                   + int(shift * 255)) % 256
    out = Image.fromarray(hsv, "HSV").convert("RGB")
    return np.asarray(out).astype(np.float32) / 255.0


class ColorJitter:
    """Numpy color jitter with torchvision-equivalent parameter ranges."""

    def __init__(self, rng: random.Random,
                 brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
        self.b = rng.uniform(*brightness)
        self.c = rng.uniform(*contrast)
        self.s = rng.uniform(*saturation)
        self.h = rng.uniform(*hue)
        self.order = list(range(4))
        rng.shuffle(self.order)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        for op in self.order:
            if op == 0:
                arr = np.clip(arr * self.b, 0, 1)
            elif op == 1:
                gray = arr.mean(axis=-1, keepdims=True).mean()
                arr = np.clip(gray + (arr - gray) * self.c, 0, 1)
            elif op == 2:
                gray = (arr * np.array([0.299, 0.587, 0.114])).sum(
                    -1, keepdims=True)
                arr = np.clip(gray + (arr - gray) * self.s, 0, 1)
            elif op == 3 and abs(self.h) > 1e-6:
                arr = _rgb_to_hsv_hue_shift(arr, self.h)
        return arr.astype(np.float32)


class MonoDataset:
    """Abstract base; subclasses implement the storage-specific hooks
    (same hook names as the reference, mono_dataset.py:230-249)."""

    def __init__(self, data_path: str, filenames: Sequence[str], height: int,
                 width: int, frame_ids: Sequence, is_train: bool = False,
                 img_ext: str = ".jpg", cfg: Optional[Config] = None,
                 seed: int = 0):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_ids = list(frame_ids)
        self.is_train = is_train
        self.img_ext = img_ext
        self.cfg = cfg or Config()
        self.rng = random.Random(seed)
        self.load_depth = self.check_depth()

    def __len__(self) -> int:
        return len(self.filenames)

    # ---- hooks ----
    def get_color(self, folder, frame_index, side, do_flip) -> Image.Image:
        raise NotImplementedError

    def check_depth(self) -> bool:
        raise NotImplementedError

    def get_depth(self, folder, frame_index, side, do_flip) -> np.ndarray:
        raise NotImplementedError

    def get_4beam(self, folder, frame_index, side, do_flip) -> np.ndarray:
        raise NotImplementedError

    def load_4beam_2channel(self, folder, frame_index, side, do_flip
                            ) -> np.ndarray:
        raise NotImplementedError

    def load_pred_depth(self, folder, frame_index, side, do_flip
                        ) -> np.ndarray:
        raise NotImplementedError

    def load_gdc(self, folder, frame_index, side, do_flip) -> np.ndarray:
        raise NotImplementedError

    def get_4beam_full(self, folder, frame_index, side, do_flip
                       ) -> np.ndarray:
        raise NotImplementedError

    # ---- assembly ----

    def parse_line(self, index: int):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def _resize_color(self, img: Image.Image) -> np.ndarray:
        img = img.resize((self.width, self.height), Image.LANCZOS)
        return np.asarray(img).astype(np.float32) / 255.0

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        do_color_aug = self.is_train and self.rng.random() > 0.5
        do_flip = self.is_train and self.rng.random() > 0.5

        folder, frame_index, side = self.parse_line(index)

        colors: List[np.ndarray] = []
        two_channels: List[np.ndarray] = []
        for i in self.frame_ids:
            if i == "s":
                other = {"r": "l", "l": "r"}[side]
                img = self.get_color(folder, frame_index, other, do_flip)
            else:
                img = self.get_color(folder, frame_index + i, side, do_flip)
            colors.append(self._resize_color(img))
            if cfg.need_2_channel:
                fi = frame_index if i == "s" else frame_index + i
                two_channels.append(
                    self.load_4beam_2channel(folder, fi, side, do_flip))

        color = np.stack(colors)  # (F, H, W, 3)
        if do_color_aug:
            jitter = ColorJitter(self.rng)
            color_aug = np.stack([jitter(c.copy()) for c in colors])
        else:
            color_aug = color.copy()

        sample: Dict[str, np.ndarray] = {
            "color": color,
            "color_aug": color_aug,
        }
        if cfg.need_path:
            # raw split line, used to name offline caches (reference
            # mono_dataset.py:143-144; collated unstacked)
            sample["path"] = self.filenames[index]
        if cfg.need_2_channel:
            sample["two_channel"] = np.stack(two_channels).astype(np.float32)

        K = self.K.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        sample["K"] = K.astype(np.float32)
        sample["inv_K"] = np.linalg.pinv(K).astype(np.float32)

        if cfg.need_4beam:
            fb = self.get_4beam(folder, frame_index, side, do_flip)
            sample["four_beam"] = (
                fb.astype(np.float32) / 100.0)[..., None]
            if cfg.need_full_res_4beam:
                # native-resolution copies (reference
                # mono_dataset.py:195-211): (375,1242) beam projection and
                # the nearest-upsampled frame-0 2channel
                full = self.get_4beam_full(folder, frame_index, side,
                                           do_flip)
                sample["four_beam_full"] = (
                    full.astype(np.float32) / 100.0)[..., None]
                if cfg.need_2_channel:
                    import cv2

                    sample["two_channel_full"] = cv2.resize(
                        sample["two_channel"][0], (1242, 375),
                        interpolation=cv2.INTER_NEAREST)

        if self.load_depth:
            sample["depth_gt"] = self.get_depth(
                folder, frame_index, side, do_flip).astype(np.float32)

        if "s" in self.frame_ids:
            stereo_T = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * baseline_sign * 0.1
            sample["stereo_T"] = stereo_T

        if (cfg.clone_gdc and self.is_train) or cfg.need_inf_gdc:
            sample["inf_gdc"] = self.load_gdc(
                folder, frame_index, side, do_flip).astype(np.float32)

        return sample
