"""DDAD dataset without the dgp SDK (JAX counterpart, of which this is a
copy: ppeadepth_tpu/data/ddad.py; the reference's DDADDataset,
ddad_dataset.py:21-167, reads through dgp). It reads a pre-exported
layout:

  <root>/rgb/{idx}_{frame}.jpg   frames at native or any resolution
  <root>/calib/{idx}.npy         3x3 K of the 1936x1216 native camera
  <root>/depth/{idx}.npy         lidar depth map of frame 0 (val only)
  <root>/val_index.txt           one sample index a line (the eval's list)

`tools/export_ddad.py` (needs dgp, run offline) writes it.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .mono_dataset import MonoDataset

RAW_W, RAW_H = 1936, 1216


class DDADNpzDataset(MonoDataset):
    """frame_idxs (0, -1, 1); filenames are sample indices, one a line."""

    def index_to_folder_and_frame_idx(self, index):
        return self.filenames[index].strip(), 0, None

    def check_depth(self):
        if not self.filenames:
            return False
        return os.path.isfile(os.path.join(
            self.data_path, "depth", f"{self.filenames[0].strip()}.npy"))

    def load_intrinsics(self, sample_id, frame_index):
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = np.load(os.path.join(self.data_path, "calib",
                                         f"{sample_id}.npy"))
        K[0, :] /= RAW_W
        K[1, :] /= RAW_H
        return K

    def get_color(self, sample_id, frame_index, side, do_flip):
        path = os.path.join(self.data_path, "rgb",
                            f"{sample_id}_{frame_index}.jpg")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        img = self.loader(path)
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def get_depth(self, sample_id, frame_index, side, do_flip):
        depth = np.load(os.path.join(self.data_path, "depth",
                                     f"{sample_id}.npy")).astype(np.float32)
        if do_flip:
            depth = depth[:, ::-1]
        return depth
