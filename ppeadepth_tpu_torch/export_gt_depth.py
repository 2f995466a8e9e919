"""Offline GT depth export (JAX counterpart: ppeadepth_tpu/
export_gt_depth.py; the reference's export_gt_depth.py:18-64): project the
velodyne scan of every line of a split's test file and store the depth
maps as <splits_dir>/<split>/gt_depths.npz, an object array under "data",
which `--eval` reads.

usage: python -m ppeadepth_tpu_torch.export_gt_depth --data_path <kitti>
           [--split eigen] [--splits_dir ./splits]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .data.kitti_utils import generate_depth_map

KITTI_SPLITS = ("eigen", "eigen_zhou", "eigen_benchmark")


def export_gt_depths(data_path: str, split: str, splits_dir: str = "./splits"):
    """Write <splits_dir>/<split>/gt_depths.npz from the velodyne scans
    under `data_path` (the KITTI raw layout) and return its path."""
    if split not in KITTI_SPLITS:
        raise NotImplementedError(f"GT export for split {split!r}; one of "
                                  f"{KITTI_SPLITS}")
    split_folder = os.path.join(splits_dir, split)
    with open(os.path.join(split_folder, "test_files.txt")) as f:
        lines = [line.rstrip() for line in f if line.rstrip()]

    print(f"Exporting ground truth depths for {split}: {len(lines)} items")
    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        calib_dir = os.path.join(data_path, folder.split("/")[0])
        velo = os.path.join(data_path, folder, "velodyne_points/data",
                            f"{int(frame_id):010d}.bin")
        gt_depths.append(
            generate_depth_map(calib_dir, velo, 2, True).astype(np.float32))

    out = os.path.join(split_folder, "gt_depths.npz")
    np.savez_compressed(out, data=np.array(gt_depths, dtype=object))
    print(f"saved to {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser("ppeadepth_tpu_torch.export_gt_depth")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="eigen")
    p.add_argument("--splits_dir", default="./splits")
    a = p.parse_args(argv)
    return export_gt_depths(a.data_path, a.split, a.splits_dir)


if __name__ == "__main__":
    main()
