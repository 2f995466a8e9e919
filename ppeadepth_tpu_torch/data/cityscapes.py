"""CityScapes loaders (JAX counterpart: ppeadepth_tpu/data/cityscapes.py,
of which this is a copy: the same PIL decode, crops, flips and intrinsics,
so both give the same bytes).

CityscapesPreprocessedDataset (cityscapes_preprocessed_dataset.py:13-96):
ManyDepth-preprocessed triplets — one wide JPG holds 3 concatenated frames
(-1, 0, +1) at 1024x384 total with the ego-car bottom 25% already cropped;
per-sequence intrinsics from '{frame}_cam.txt' normalised by 1024x384.

CityscapesEvalDataset (cityscapes_evaldataset.py:15-122): raw leftImg8bit
test frames cropped to the top 75%, frame -2 as the lookup frame,
intrinsics from the camera JSON normalised by 2048 x (1024*0.75).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from .mono_dataset import MonoDataset


class CityscapesPreprocessedDataset(MonoDataset):
    RAW_WIDTH = 1024
    RAW_HEIGHT = 384
    _loads_all_colors = True

    def index_to_folder_and_frame_idx(self, index):
        city, frame_name = self.filenames[index].split()
        return city, frame_name, None

    def check_depth(self):
        return False

    def load_intrinsics(self, city, frame_name):
        camera_file = os.path.join(
            self.data_path, city, "{}_cam.txt".format(frame_name)
        )
        camera = np.loadtxt(camera_file, delimiter=",")
        fx, fy, u0, v0 = camera[0], camera[4], camera[2], camera[5]
        K = np.array(
            [[fx, 0, u0, 0], [0, fy, v0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            dtype=np.float32,
        )
        K[0, :] /= self.RAW_WIDTH
        K[1, :] /= self.RAW_HEIGHT
        return K

    def get_image_path(self, city, frame_name):
        return os.path.join(self.data_path, city, f"{frame_name}.jpg")

    def get_colors(self, city, frame_name, side, do_flip):
        if side is not None:
            raise ValueError("cityscapes has no stereo sides here")
        wide = np.array(self.loader(self.get_image_path(city, frame_name)))
        w = wide.shape[1] // 3
        frames = {
            -1: wide[:, :w], 0: wide[:, w:2 * w], 1: wide[:, 2 * w:],
        }
        out = {}
        for f, arr in frames.items():
            img = Image.fromarray(arr)
            if do_flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            out[("color", f, -1)] = img
        return out


class CityscapesEvalDataset(MonoDataset):
    RAW_HEIGHT = 1024
    RAW_WIDTH = 2048
    _loads_all_colors = True

    def index_to_folder_and_frame_idx(self, index):
        city, frame_name = self.filenames[index].split()
        return city, frame_name, None

    def check_depth(self):
        return False

    def load_intrinsics(self, city, frame_name):
        camera_file = os.path.join(
            self.data_path, "camera_trainvaltest", "camera", "test",
            city, frame_name + "_camera.json",
        )
        with open(camera_file) as f:
            camera = json.load(f)
        fx = camera["intrinsic"]["fx"]
        fy = camera["intrinsic"]["fy"]
        u0 = camera["intrinsic"]["u0"]
        v0 = camera["intrinsic"]["v0"]
        K = np.array(
            [[fx, 0, u0, 0], [0, fy, v0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            dtype=np.float32,
        )
        K[0, :] /= self.RAW_WIDTH
        K[1, :] /= self.RAW_HEIGHT * 0.75
        return K

    def get_image_path(self, city, frame_name, is_sequence=False):
        folder = "leftImg8bit" if not is_sequence else "leftImg8bit_sequence"
        return os.path.join(
            self.data_path, folder, "test", city,
            frame_name + "_leftImg8bit.png",
        )

    def _get_one(self, city, frame_name, do_flip, is_sequence=False):
        color = self.loader(
            self.get_image_path(city, frame_name, is_sequence)
        )
        w, h = color.size
        color = color.crop((0, 0, w, h * 3 // 4))  # drop ego car
        if do_flip:
            color = color.transpose(Image.FLIP_LEFT_RIGHT)
        return color

    @staticmethod
    def get_offset_framename(frame_name, offset=-2):
        city, seq, frame_num = frame_name.split("_")
        return f"{city}_{seq}_{str(int(frame_num) + offset).zfill(6)}"

    def get_colors(self, city, frame_name, side, do_flip):
        if side is not None:
            raise ValueError("cityscapes has no stereo sides here")
        out = {
            ("color", 0, -1): self._get_one(city, frame_name, do_flip),
            ("color", -1, -1): self._get_one(
                city, self.get_offset_framename(frame_name, -2), do_flip,
                is_sequence=True,
            ),
        }
        return out
