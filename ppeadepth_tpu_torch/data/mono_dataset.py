"""Base triplet dataset: frames {0,-1,+1} (+extra matching frames), 4-scale
LANCZOS pyramid, per-scale intrinsics, shared-per-item color jitter, 50%
horizontal flip, missing-frame zero-dummy protocol.

Schema matches the reference (mono_dataset.py:33-210): a dict keyed
  ("color"/"color_aug", frame_id, scale) -> float32 HWC in [0, 1]
  ("K"/"inv_K", scale)                   -> float32 [4, 4]
with the same conventions: blank (missing) frames keep color_aug zeroed so
the model can detect them (mono_dataset.py:108-112 -> repdepth.py:502-506);
the SAME jitter is applied to every frame of an item so the pose network
sees consistent appearance (mono_dataset.py:89-112).

Arrays are NHWC numpy — batching/stacking happens in loader.py; device
placement is the trainer's job. A copy of the JAX package's
data/mono_dataset.py: the same PIL decode, LANCZOS resize and per-item
`random.Random(seed, epoch, index)` draws, so both give the same bytes.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np
from PIL import Image, ImageEnhance


def pil_loader(path: str) -> Image.Image:
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


class ColorJitter:
    """brightness/contrast/saturation in [0.8, 1.2], hue in [-0.1, 0.1],
    applied in a random order (torchvision ColorJitter semantics)."""

    def __init__(self, rng: random.Random):
        self.brightness = rng.uniform(0.8, 1.2)
        self.contrast = rng.uniform(0.8, 1.2)
        self.saturation = rng.uniform(0.8, 1.2)
        self.hue = rng.uniform(-0.1, 0.1)
        self.order = list(range(4))
        rng.shuffle(self.order)

    def __call__(self, img: Image.Image) -> Image.Image:
        for op in self.order:
            if op == 0:
                img = ImageEnhance.Brightness(img).enhance(self.brightness)
            elif op == 1:
                img = ImageEnhance.Contrast(img).enhance(self.contrast)
            elif op == 2:
                img = ImageEnhance.Color(img).enhance(self.saturation)
            else:
                hsv = np.array(img.convert("HSV"), dtype=np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(self.hue * 255)) % 256
                img = Image.fromarray(
                    hsv.astype(np.uint8), "HSV"
                ).convert("RGB")
        return img


def to_array(img: Image.Image) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


class MonoDataset:
    def __init__(
        self,
        data_path: str,
        filenames: List[str],
        height: int,
        width: int,
        frame_idxs,
        num_scales: int = 4,
        is_train: bool = False,
        img_ext: str = ".jpg",
        seed: int = 0,
    ):
        self.data_path = data_path
        self.filenames = filenames
        self.height = height
        self.width = width
        self.num_scales = num_scales
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.img_ext = img_ext
        self.loader = pil_loader
        self.interp = Image.LANCZOS
        self.load_depth = self.check_depth()
        self._base_seed = seed

    def __len__(self):
        return len(self.filenames)

    # ------------------------------------------------------------------ #
    # subclass hooks
    def index_to_folder_and_frame_idx(self, index):
        raise NotImplementedError

    def get_color(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def check_depth(self) -> bool:
        return False

    def get_depth(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def load_intrinsics(self, folder, frame_index) -> np.ndarray:
        return self.K.copy()

    # ------------------------------------------------------------------ #

    def __getitem__(self, index: int, epoch: int = 0) -> Dict:
        rng = random.Random(
            (self._base_seed * 1_000_003 + epoch) * len(self) + index
        )
        do_color_aug = self.is_train and rng.random() > 0.5
        do_flip = self.is_train and rng.random() > 0.5

        folder, frame_index, side = self.index_to_folder_and_frame_idx(index)

        raw: Dict = {}
        for i in self.frame_idxs:
            if i == "s":
                other_side = {"r": "l", "l": "r"}[side]
                raw[("color", i, -1)] = self.get_color(
                    folder, frame_index, other_side, do_flip
                )
            else:
                try:
                    raw[("color", i, -1)] = self.get_color(
                        folder, frame_index + i, side, do_flip
                    )
                except FileNotFoundError:
                    if i != 0:
                        # missing neighbor -> dummy zeros
                        # (mono_dataset.py:161-166)
                        raw[("color", i, -1)] = Image.fromarray(
                            np.zeros((100, 100, 3), np.uint8)
                        )
                    else:
                        raise

        inputs: Dict = {}
        for scale in range(self.num_scales):
            K = self.load_intrinsics(folder, frame_index)
            K[0, :] *= self.width // (2 ** scale)
            K[1, :] *= self.height // (2 ** scale)
            inputs[("K", scale)] = K.astype(np.float32)
            inputs[("inv_K", scale)] = np.linalg.pinv(K).astype(np.float32)

        jitter = ColorJitter(rng) if do_color_aug else (lambda im: im)

        for key in list(raw):
            _, im, _ = key
            prev = raw[key]
            for scale in range(self.num_scales):
                s = 2 ** scale
                img = prev.resize(
                    (self.width // s, self.height // s), self.interp
                )
                arr = to_array(img)
                inputs[("color", im, scale)] = arr
                if arr.sum() == 0:
                    # blank frame: keep aug zeroed (mono_dataset.py:108-112)
                    inputs[("color_aug", im, scale)] = arr
                else:
                    inputs[("color_aug", im, scale)] = to_array(jitter(img))
                prev = img

        if self.load_depth and not self.is_train:
            depth_gt = self.get_depth(folder, frame_index, side, do_flip)
            inputs["depth_gt"] = depth_gt[..., None].astype(np.float32)

        return inputs
