"""Per-block adapter ablation CLI (JAX counterpart: ppeadepth_tpu/
evaluate_depth_layer.py; the reference's evaluate_depth_layer.py:353-430):
gate off each encoder block's adapter in turn, evaluate the student, and
log AbsRel and a1 per block to repl.txt.

usage: python -m ppeadepth_tpu_torch.evaluate_depth_layer
           --load_weights_folder <ckpt> --data_path <kitti> [--rep_size l]
"""

from __future__ import annotations

import os
import sys


def make_eval_fn(opt, device="cuda", splits_dir: str = "./splits"):
    """(eval_fn, state_dict): a copy of the state_dict of the model of
    `opt.load_weights_folder` (seeded random weights when None) on
    `device`, and eval_fn(state_dict) -> the student's mean_errors [7] on
    <splits_dir>/<split>/test_files.txt, evaluated as `--eval` evaluates
    (f32 convs without TF32) with those weights loaded into that model."""
    from . import data as D
    from .eval import evaluator
    from .evaluate_depth import load_eval_model
    from .models.repdepth import cudnn_without_tf32
    from .train.trainer import readlines, resolve_device

    opt = opt.with_mode_presets()
    device = resolve_device(device)
    model, min_bin, max_bin = load_eval_model(opt, device)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    files = readlines(os.path.join(splits_dir, opt.split, "test_files.txt"))
    ds = D.DATASETS[opt.dataset](
        opt.data_path, files, opt.height, opt.width, [0, -1], 4,
        is_train=False, img_ext=".png" if opt.png else ".jpg")

    def eval_fn(sd):
        model.load_state_dict(sd, strict=True)
        loader = D.DataLoader(ds, opt.batch_size, shuffle=False,
                              num_workers=opt.num_workers, drop_last=False)
        with cudnn_without_tf32():
            errors, _ = evaluator.run_eval(
                model, opt, iter(loader), min_bin=min_bin, max_bin=max_bin,
                splits_dir=splits_dir, device=device)
        return errors

    return eval_fn, state_dict


def main(argv=None, device="cuda", splits_dir: str = "./splits"):
    from .eval import ablation
    from .options import parse_args

    eval_fn, state_dict = make_eval_fn(parse_args(argv), device, splits_dir)
    results = ablation.run_block_ablation(
        eval_fn, state_dict, submodules=("encoder", "mono_encoder"),
        out_path="repl.txt")
    print(f"wrote {len(results)} block ablations to repl.txt")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
