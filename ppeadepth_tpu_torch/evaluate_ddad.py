"""DDAD evaluation (JAX counterpart: ppeadepth_tpu/evaluate_ddad.py; the
reference's evaluate_ddad.py):

    python -m ppeadepth_tpu_torch.evaluate_ddad --load_weights_folder <ckpt>
        --data_path <ddad_npz_root> [--eval_native_res] [--lk_backend pallas]

Inputs are resized to 320x480 as the reference forces (:251-255) unless
`--eval_native_res` keeps the model's resolution; depths are clamped at
200 m; the GT is one .npy a sample (`data.ddad.DDADNpzDataset`), the
samples those of <data_path>/val_index.txt.
"""

from __future__ import annotations

import os
import sys

MAX_VAL = 200.0  # DDAD's depth clamp, in metres


def eval_config(opt):
    """The DDAD preset, then the reference's forced 320x480 eval resolution
    (evaluate_ddad.py:251-255); `--eval_native_res` keeps the preset's
    (or an explicit) resolution."""
    opt = opt.replace(ddad=True).with_mode_presets()
    if not opt.eval_native_res:
        opt = opt.replace(height=320, width=480)
    return opt


def evaluate(opt, device="cuda"):
    """Evaluate `opt.load_weights_folder` (random weights when None) on the
    DDAD layout under `opt.data_path`. Returns (mean_errors [7], teacher
    mean_errors [7] or None)."""
    from .data.ddad import DDADNpzDataset
    from .evaluate_depth import load_eval_model, run_and_report
    from .train.trainer import readlines, resolve_device

    opt = eval_config(opt)
    device = resolve_device(device)
    model, min_bin, max_bin = load_eval_model(opt, device)
    files = readlines(os.path.join(opt.data_path, "val_index.txt"))
    ds = DDADNpzDataset(opt.data_path, files, opt.height, opt.width, [0, -1],
                        4, is_train=False)
    gt_depths = [ds.get_depth(f.strip(), 0, None, False) for f in files]
    return run_and_report(model, opt, ds, device, min_bin, max_bin,
                          gt_depths=gt_depths, max_val=MAX_VAL)


def main(argv=None):
    from .options import parse_args

    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
