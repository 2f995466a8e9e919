"""Host-side (numpy/cv2) evaluation metric pass — bit-for-bit the
reference protocol (trainer.py:757-847, evaluate_depth.py:35-53):

  resize pred disp to GT size (cv2 bilinear) -> 1/disp -> split crop
  (eigen crop, or cityscapes [256:, 192:1856] after the 75% ego crop) ->
  validity mask (MIN_VAL < gt < MAX_VAL) -> per-image median scaling ->
  clamp [MIN_VAL, MAX_VAL] -> 7 errors averaged over images.

This deliberately stays in numpy (SURVEY hard-part 8): eval parity against
published AbsRel depends on cv2.resize exactness. A copy of the JAX
package's eval/metrics.py, so the port imports nothing of it.
"""

from __future__ import annotations


import numpy as np

try:
    import cv2

    cv2.setNumThreads(0)
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

METRIC_NAMES = [
    "de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms",
    "da/a1", "da/a2", "da/a3",
]


def compute_errors(gt: np.ndarray, pred: np.ndarray):
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 on flat valid pixels."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def _resize(disp: np.ndarray, width: int, height: int) -> np.ndarray:
    if _HAS_CV2:
        return cv2.resize(disp, (width, height))
    from PIL import Image

    return np.asarray(
        Image.fromarray(disp).resize((width, height), Image.BILINEAR)
    )


def eigen_crop_mask(gt_depth, min_val, max_val):
    gt_h, gt_w = gt_depth.shape[:2]
    mask = np.logical_and(gt_depth > min_val, gt_depth < max_val)
    crop = np.array(
        [0.40810811 * gt_h, 0.99189189 * gt_h,
         0.03594771 * gt_w, 0.96405229 * gt_w]
    ).astype(np.int32)
    crop_mask = np.zeros(mask.shape)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    return np.logical_and(mask, crop_mask)


def evaluate_disps(
    pred_disps: np.ndarray,
    gt_depths,
    eval_split: str = "eigen",
    min_val: float = 1e-3,
    max_val: float = 80.0,
    disable_median_scaling: bool = False,
    pred_depth_scale_factor: float = 1.0,
):
    """pred_disps: [N, h, w] scaled disparities; gt_depths: sequence of
    per-image GT depth maps. Returns (mean_errors [7], ratios [N])."""
    errors, ratios = [], []
    for i in range(pred_disps.shape[0]):
        gt_depth = np.asarray(gt_depths[i])
        if eval_split == "cityscapes":
            gt_h = int(round(gt_depth.shape[0] * 0.75))
            gt_depth = gt_depth[:gt_h]
        gt_h, gt_w = gt_depth.shape[:2]

        pred_disp = _resize(pred_disps[i], gt_w, gt_h)
        pred_depth = 1.0 / pred_disp

        if eval_split == "cityscapes":
            gt_depth = gt_depth[256:, 192:1856]
            pred_depth = pred_depth[256:, 192:1856]

        if eval_split == "eigen":
            mask = eigen_crop_mask(gt_depth, min_val, max_val)
        else:
            mask = np.logical_and(gt_depth > min_val, gt_depth < max_val)

        pred_depth = pred_depth[mask]
        gt = gt_depth[mask]
        # in-place like the reference (trainer.py:822-829): the f64
        # median ratio must NOT promote the f32 depths (bit-exactness
        # pinned by tests/test_eval_oracle.py)
        pred_depth *= pred_depth_scale_factor
        if not disable_median_scaling:
            ratio = np.median(gt) / np.median(pred_depth)
            ratios.append(ratio)
            pred_depth *= ratio
        pred_depth = np.clip(pred_depth, min_val, max_val)
        errors.append(compute_errors(gt, pred_depth))
    return np.array(errors).mean(0), np.array(ratios)


def format_metrics(mean_errors) -> str:
    head = "  ".join(f"{n:>10}" for n in METRIC_NAMES)
    vals = "  ".join(f"{v:10.3f}" for v in mean_errors)
    return head + "\n" + vals


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray):
    """Monodepth-v1 flip post-processing (evaluate_depth.py:56-64):
    blend the disparity of the image and of its horizontal flip with
    edge-favouring masks. l_disp/r_disp: [N, h, w] (r_disp already
    un-flipped)."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    lgrid, _ = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    l_mask = (1.0 - np.clip(20 * (lgrid - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return (r_mask * l_disp + l_mask * r_disp
            + (1.0 - l_mask - r_mask) * m_disp)
