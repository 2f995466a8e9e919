"""Standalone checkpoint evaluation: `python -m ppeadepth_tpu_torch.train
--eval --load_weights_folder <ckpt> ...` (JAX counterpart:
ppeadepth_tpu/evaluate_depth.py; the reference's evaluate_depth.py:301-399).

Loads model.pth and the depth bins of track.json, runs the eval harness
over the test split and prints the 7 metrics and the average wall time per
image.
"""

from __future__ import annotations

import os
import sys
import time

import torch


def load_eval_model(opt, device):
    """(model, min_bin, max_bin): the RepDepth of `opt` on `device` in eval
    mode with the weights of `opt.load_weights_folder` (seeded random when
    None) and the depth-bin range of its track.json (0.1-10 otherwise)."""
    from .ckpt import io as ckpt_io
    from .models import RepDepth, init_weights

    model = RepDepth(opt)
    init_weights(model, torch.Generator().manual_seed(0))
    min_bin, max_bin = 0.1, 10.0
    if opt.load_weights_folder:
        track = ckpt_io.load_model(opt.load_weights_folder, model)
        min_bin = track.get("min_depth_bin", min_bin)
        max_bin = track.get("max_depth_bin", max_bin)
    return model.to(device).eval(), min_bin, max_bin


def run_and_report(model, opt, ds, device, min_bin, max_bin, **kw):
    """`evaluator.run_eval` of `model` over the dataset `ds` (batches of
    opt.batch_size) with f32 convs in f32 (cuDNN TF32 off, as the JAX eval
    computes), `kw` passed on; prints the average wall time per image and
    the metrics. Returns (mean_errors [7], teacher mean_errors or None)."""
    from . import data as D
    from .eval import evaluator, metrics as M
    from .models.repdepth import cudnn_without_tf32

    loader = D.DataLoader(ds, opt.batch_size, shuffle=False,
                          num_workers=opt.num_workers, drop_last=False)
    t0 = time.perf_counter()
    with cudnn_without_tf32():
        errors, mono_errors = evaluator.run_eval(
            model, opt, iter(loader), min_bin=min_bin, max_bin=max_bin,
            with_teacher=opt.eval_teacher, device=device, **kw)
    dt = time.perf_counter() - t0
    print(f"avg wall-clock per image: {dt / len(ds) * 1000:.2f} ms")
    print(M.format_metrics(errors))
    if mono_errors is not None:
        print("teacher:")
        print(M.format_metrics(mono_errors))
    return errors, mono_errors


def evaluate(opt, device="cuda", splits_dir: str = "./splits"):
    """Evaluate `opt.load_weights_folder` (random weights when None) on
    `splits_dir`/<split>/test_files.txt against the GT depths of
    <eval_split> (`evaluator.load_gt_depths`): KITTI images under
    `opt.data_path`, or, for `--eval_split cityscapes`, the
    `cityscapes_eval` layout under `opt.cs_eval_path`. Returns
    (mean_errors [7], teacher mean_errors [7] or None)."""
    from . import data as D
    from .train.trainer import readlines, resolve_device

    opt = opt.with_mode_presets()
    device = resolve_device(device)
    model, min_bin, max_bin = load_eval_model(opt, device)
    files = readlines(os.path.join(splits_dir, opt.split, "test_files.txt"))
    if opt.eval_split == "cityscapes":
        ds_cls, data_path = D.DATASETS["cityscapes_eval"], opt.cs_eval_path
    else:
        ds_cls, data_path = D.DATASETS["kitti"], opt.data_path
    ds = ds_cls(data_path, files, opt.height, opt.width, [0, -1], 4,
                is_train=False, img_ext=".png" if opt.png else ".jpg")
    return run_and_report(model, opt, ds, device, min_bin, max_bin,
                          splits_dir=splits_dir)


def main(argv=None):
    from .options import parse_args

    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
