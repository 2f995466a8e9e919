"""KITTI velodyne -> sparse depth-map projection.

A copy of the JAX package's data/kitti_utils.py (numpy only); behavioral
equivalent of ppeadepth/kitti_utils.py:50-102 (the standard
KITTI-raw pipeline): read calib_cam_to_cam / calib_velo_to_cam, rectify,
project lidar points into the chosen camera, keep points in front of the
camera and inside the image, and resolve duplicate pixels by keeping the
nearest depth.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np


def read_calib_file(path: str) -> dict:
    """Parse 'key: v0 v1 ...' calibration files; non-numeric values kept
    as strings."""
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array(
                    [float(x) for x in value.split()], dtype=np.float64
                )
            except ValueError:
                data[key] = value
    return data


def load_velodyne_points(path: str) -> np.ndarray:
    """Velodyne .bin -> [N, 4] float32 (x, y, z, reflectance->1)."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def sub2ind(shape, rows, cols):
    return rows * shape[1] + cols


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse depth map for camera `cam` (2=left color, 3=right color)."""
    cam2cam = read_calib_file(
        os.path.join(calib_dir, "calib_cam_to_cam.txt")
    )
    velo2cam_f = read_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt")
    )
    velo2cam = np.hstack(
        (velo2cam_f["R"].reshape(3, 3), velo2cam_f["T"].reshape(3, 1))
    )
    velo2cam = np.vstack((velo2cam, [0, 0, 0, 1.0]))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)  # (H, W)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0, :]  # points forward of the lidar

    pts_im = (P_velo2im @ velo.T).T
    pts_im[:, :2] = pts_im[:, :2] / pts_im[:, 2:3]
    if vel_depth:
        pts_im[:, 2] = velo[:, 0]

    # KITTI-matlab convention: -1 then round
    pts_im[:, 0] = np.round(pts_im[:, 0]) - 1
    pts_im[:, 1] = np.round(pts_im[:, 1]) - 1
    valid = (
        (pts_im[:, 0] >= 0) & (pts_im[:, 1] >= 0)
        & (pts_im[:, 0] < im_shape[1]) & (pts_im[:, 1] < im_shape[0])
        & (pts_im[:, 2] > 0)
    )
    pts_im = pts_im[valid]

    depth = np.zeros(im_shape, dtype=np.float32)
    xs = pts_im[:, 0].astype(np.int32)
    ys = pts_im[:, 1].astype(np.int32)
    depth[ys, xs] = pts_im[:, 2]

    # duplicate pixels: keep the minimum depth
    inds = sub2ind(depth.shape, ys, xs)
    dupes = [item for item, cnt in Counter(inds).items() if cnt > 1]
    for dd in dupes:
        pts = np.where(inds == dd)[0]
        x_loc = int(pts_im[pts[0], 0])
        y_loc = int(pts_im[pts[0], 1])
        depth[y_loc, x_loc] = pts_im[pts, 2].min()

    depth[depth < 0] = 0
    return depth
