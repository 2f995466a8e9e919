"""KITTI dataset loaders (kitti_dataset.py:19-149); a copy of the JAX
package's data/kitti.py.

Intrinsics are the dataset-normalised constants of the reference
(kitti_dataset.py:26-29); image layout folder/image_0{2,3}/data/{:010d}.ext.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .kitti_utils import generate_depth_map
from .mono_dataset import MonoDataset


class KITTIDataset(MonoDataset):
    K = np.array(
        [[0.58, 0, 0.5, 0],
         [0, 1.92, 0.5, 0],
         [0, 0, 1, 0],
         [0, 0, 0, 1]], dtype=np.float32,
    )
    full_res_shape = (1242, 375)
    side_map = {"2": 2, "3": 3, "l": 2, "r": 3}

    def check_depth(self):
        if not self.filenames:
            return False
        line = self.filenames[0].split()
        if len(line) < 2:
            return False
        velo = os.path.join(
            self.data_path, line[0],
            "velodyne_points/data/{:010d}.bin".format(int(line[1])),
        )
        return os.path.isfile(velo)

    def index_to_folder_and_frame_idx(self, index):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def get_color(self, folder, frame_index, side, do_flip):
        color = self.loader(self.get_image_path(folder, frame_index, side))
        if do_flip:
            color = color.transpose(Image.FLIP_LEFT_RIGHT)
        return color


class KITTIRAWDataset(KITTIDataset):
    def get_image_path(self, folder, frame_index, side):
        f_str = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(
            self.data_path, folder,
            "image_0{}/data".format(self.side_map[side]), f_str,
        )

    def get_depth(self, folder, frame_index, side, do_flip):
        calib_path = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(
            self.data_path, folder,
            "velodyne_points/data/{:010d}.bin".format(int(frame_index)),
        )
        depth_gt = generate_depth_map(calib_path, velo, self.side_map[side])
        # skimage-free nearest resize to the canonical full res
        img = Image.fromarray(depth_gt)
        img = img.resize(self.full_res_shape, Image.NEAREST)
        depth_gt = np.asarray(img, dtype=np.float32)
        if do_flip:
            depth_gt = depth_gt[:, ::-1]
        return depth_gt


class KITTIOdomDataset(KITTIDataset):
    def index_to_folder_and_frame_idx(self, index):
        line = self.filenames[index].split()
        folder = "sequences/{:02d}".format(int(line[0]))
        frame_index = int(line[1])
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def get_image_path(self, folder, frame_index, side):
        f_str = "{:06d}{}".format(frame_index, self.img_ext)
        return os.path.join(
            self.data_path, folder,
            "image_{}".format(self.side_map[side]), f_str,
        )


class KITTIDepthDataset(KITTIDataset):
    """Uses the official annotated depth maps instead of raw velodyne."""

    def get_image_path(self, folder, frame_index, side):
        f_str = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(
            self.data_path, folder,
            "image_0{}/data".format(self.side_map[side]), f_str,
        )

    def get_depth(self, folder, frame_index, side, do_flip):
        f_str = "{:010d}.png".format(frame_index)
        path = os.path.join(
            self.data_path, folder,
            "proj_depth/groundtruth/image_0{}".format(self.side_map[side]),
            f_str,
        )
        depth = Image.open(path).resize(self.full_res_shape, Image.NEAREST)
        depth_gt = np.asarray(depth, dtype=np.float32) / 256.0
        if do_flip:
            depth_gt = depth_gt[:, ::-1]
        return depth_gt
