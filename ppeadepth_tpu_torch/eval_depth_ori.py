"""Legacy ManyDepth-style evaluation (JAX counterpart:
ppeadepth_tpu/eval_depth_ori.py; the reference's eval_depth_ori.py:87-431):

  python -m ppeadepth_tpu_torch.eval_depth_ori --load_weights_folder <dir> ...

Reads the reference's separate-file checkpoints (encoder.pth, depth.pth,
pose_encoder.pth, pose.pth; or mono_encoder.pth and mono_depth.pth under
--eval_teacher) into the legacy ResnetEncoderMatching + Monodepth2
DepthDecoder pair (models/resnet_matching.py), strictly. The depth-bin
range rides in encoder.pth (0.1 / 20 when absent). Options as in JAX:

  --save_pred_disps        save {tag}_{split}_split.npy in the checkpoint
                           folder (tag = zero_cv | teacher | multi)
  --no_eval                stop after predicting and saving
  --ext_disp_to_eval PATH  evaluate a saved .npy instead of predicting
  --eval_split benchmark   write 16-bit KITTI-benchmark depth PNGs at
                           1216x352 (depth = 5.4 / disp in [0, 80], x256)
  --zero_cost_volume / --static_camera / --eval_teacher

The device pass runs f32 with cuDNN TF32 off, on the card unless the
caller passes device="cpu".
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

STEREO_SCALE_FACTOR = 5.4  # eval_depth_ori.py:30-31
BENCHMARK_W, BENCHMARK_H = 1216, 352
DEFAULT_BINS = (0.1, 20.0)  # eval_depth_ori.py:137-143
# saved beside the weights and not module state: the encoder's unused
# 1x1 pre-matching conv, the pixel grids of its (Backproject, Project3D)
# helpers, and torchvision's classifier head in the ResNet encoders
_NOT_STATE = ("prematching_conv.", "backprojector.", "projector.",
              "encoder.fc.")
_EXTRAS = ("min_depth_bin", "max_depth_bin", "height", "width")


def legacy_state_dict(path: str):
    """(state_dict, extras) of a legacy checkpoint file: the tensors that
    are module state, and the rest (e.g. encoder.pth's `min_depth_bin`,
    `max_depth_bin`, `height`, `width`) as a dict."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd, extras = {}, {}
    for k, v in blob.items():
        if k in _EXTRAS or not torch.is_tensor(v):
            extras[k] = v
        elif not k.startswith(_NOT_STATE):
            sd[k] = v
    return sd, extras


def _load(module, folder: str, fname: str):
    """Load `folder`/`fname` into `module` strictly; returns the extras."""
    sd, extras = legacy_state_dict(os.path.join(folder, fname))
    module.load_state_dict(sd, strict=True)
    return extras


def save_benchmark_pngs(pred_disps: np.ndarray, save_dir: str) -> None:
    """KITTI benchmark submission files (eval_depth_ori.py:319-327): each
    disparity resized to 1216x352 (PIL bilinear), depth = 5.4 / disp
    clipped to [0, 80], written as a uint16 PNG of 256 x depth."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    for idx in range(len(pred_disps)):
        disp = np.asarray(Image.fromarray(pred_disps[idx]).resize(
            (BENCHMARK_W, BENCHMARK_H), Image.BILINEAR))
        depth = np.clip(STEREO_SCALE_FACTOR / disp, 0, 80)
        Image.fromarray((depth * 256).astype(np.uint16)).save(
            os.path.join(save_dir, f"{idx:010d}.png"))


def _chained_poses(pose_pair, frames, frames_to_load):
    """Relative poses [B, F, 4, 4] current -> each lookup frame, chained
    through the frames between (eval_depth_ori.py:222-247)."""
    rel = {}
    for fi in frames_to_load[1:]:
        if fi < 0:
            T = pose_pair(frames[fi], frames[fi + 1], invert=True)
            if fi != -1:
                T = T @ rel[fi + 1]
        else:
            T = pose_pair(frames[fi - 1], frames[fi], invert=False)
            if fi != 1:
                T = T @ rel[fi - 1]
        rel[fi] = T
    return torch.stack([rel[fi] for fi in frames_to_load[1:]], 1)


def make_predict_step(opt, folder: str, device):
    """step(batch) -> scaled disparities [B, H, W] of the legacy student
    (or, under `opt.eval_teacher`, of the mono teacher) loaded from
    `folder`; `batch` the loader's dict as tensors on `device`, colours
    NHWC."""
    from .core.geometry import disp_to_depth, transformation_from_parameters
    from .models.pose import PoseDecoder
    from .models.resnet import ResnetEncoder
    from .models.resnet_matching import DepthDecoder, ResnetEncoderMatching

    frames_to_load = list(dict.fromkeys([0] + list(opt.matching_ids[1:])))

    def image(batch, f):
        return batch[("color", f, 0)].float().permute(0, 3, 1, 2)

    def scaled(out):
        return disp_to_depth(out[("disp", 0)], opt.min_depth,
                             opt.max_depth)[0][:, 0]

    if opt.eval_teacher:
        enc = ResnetEncoder(num_layers=opt.num_layers)
        dec = DepthDecoder(enc.num_ch_enc)
        _load(enc, folder, "mono_encoder.pth")
        _load(dec, folder, "mono_depth.pth")
        enc, dec = enc.to(device).eval(), dec.to(device).eval()

        def step(batch):
            return scaled(dec(enc(image(batch, 0))))

        return step

    enc = ResnetEncoderMatching(opt.num_layers, opt.num_depth_bins,
                                opt.depth_binning)
    dec = DepthDecoder(enc.num_ch_enc)
    pose_enc = ResnetEncoder(18, num_input_images=2)
    pose_dec = PoseDecoder(pose_enc.num_ch_enc, num_frames_to_predict_for=2)
    extras = _load(enc, folder, "encoder.pth")
    min_bin = float(extras.get("min_depth_bin", DEFAULT_BINS[0]))
    max_bin = float(extras.get("max_depth_bin", DEFAULT_BINS[1]))
    _load(dec, folder, "depth.pth")
    _load(pose_enc, folder, "pose_encoder.pth")
    _load(pose_dec, folder, "pose.pth")
    for m in (enc, dec, pose_enc, pose_dec):
        m.to(device).eval()

    def pose_pair(a, b, invert):
        aa, tt = pose_dec(pose_enc(torch.cat([a, b], 1)))
        return transformation_from_parameters(aa[:, 0, 0], tt[:, 0, 0],
                                              invert=invert)

    def step(batch):
        frames = {fi: image(batch, fi) for fi in frames_to_load}
        if opt.static_camera:
            frames = {fi: frames[0] for fi in frames_to_load}
        rel_poses = _chained_poses(pose_pair, frames, frames_to_load)
        if opt.zero_cost_volume:
            rel_poses = rel_poses * 0.0
        lookup = torch.stack([frames[fi] for fi in frames_to_load[1:]], 1)
        feats, _, _ = enc(frames[0], lookup, rel_poses,
                          batch[("K", 2)].float(), batch[("inv_K", 2)].float(),
                          min_bin, max_bin)
        return scaled(dec(feats))

    return step


def predict_disps(opt, splits_dir: str = "./splits", device="cuda"):
    """The inference pass over `splits_dir`/<eval_split>/test_files.txt:
    scaled disparities [N, H, W] (numpy f32)."""
    from . import data as D
    from .models.repdepth import cudnn_without_tf32
    from .train.trainer import readlines, resolve_device

    device = resolve_device(device)
    folder = os.path.expanduser(opt.load_weights_folder or "")
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"no checkpoint folder {folder!r}")
    frames_to_load = list(dict.fromkeys([0] + list(opt.matching_ids[1:])))
    step = make_predict_step(opt, folder, device)
    files = readlines(os.path.join(splits_dir, opt.eval_split,
                                   "test_files.txt"))
    if opt.eval_split == "cityscapes":
        ds_cls, data_path = D.DATASETS["cityscapes_eval"], opt.cs_eval_path
    else:
        ds_cls, data_path = D.DATASETS["kitti"], opt.data_path
    ds = ds_cls(data_path, files, opt.height, opt.width, frames_to_load, 4,
                is_train=False, img_ext=".png" if opt.png else ".jpg")
    loader = D.DataLoader(ds, opt.batch_size, shuffle=False,
                          num_workers=opt.num_workers, drop_last=False)
    disps = []
    with cudnn_without_tf32(), torch.inference_mode():
        for batch in loader:
            batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            disps.append(step(batch).cpu().numpy())
    return np.concatenate(disps, 0)


def evaluate(opt, splits_dir: str = "./splits", device="cuda"):
    """Predict (or read `--ext_disp_to_eval`), optionally save, then score
    against the GT depths of <eval_split> (or write the benchmark PNGs).
    Returns the 7 mean errors, or None when nothing is scored."""
    from .eval import evaluator, metrics as M

    if opt.ext_disp_to_eval is not None:
        print(f"-> loading predictions from {opt.ext_disp_to_eval}")
        pred_disps = np.load(opt.ext_disp_to_eval)
    else:
        pred_disps = predict_disps(opt, splits_dir, device)

    if opt.save_pred_disps:
        tag = ("zero_cv" if opt.zero_cost_volume
               else "teacher" if opt.eval_teacher else "multi")
        out = os.path.join(opt.load_weights_folder,
                           f"{tag}_{opt.eval_split}_split.npy")
        print(f"-> saving predicted disparities to {out}")
        np.save(out, pred_disps)

    if opt.no_eval:
        print("-> evaluation disabled; done")
        return None

    if opt.eval_split == "benchmark":
        save_dir = os.path.join(opt.load_weights_folder,
                                "benchmark_predictions")
        print(f"-> exporting benchmark predictions to {save_dir}")
        save_benchmark_pngs(pred_disps, save_dir)
        print("-> no ground truth for the KITTI benchmark; done")
        return None

    gt_depths = evaluator.load_gt_depths(opt, pred_disps.shape[0], splits_dir)
    errors, _ = M.evaluate_disps(
        pred_disps, gt_depths, opt.eval_split, 1e-3, 80.0,
        opt.disable_median_scaling, opt.pred_depth_scale_factor)
    print(M.format_metrics(errors))
    return errors


def main(argv=None):
    from .options import parse_args

    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
