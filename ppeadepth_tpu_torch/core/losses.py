"""Self-supervised photometric loss primitives (JAX counterpart:
core/losses.py; reference layers.py:210-257, trainer.py:859-869,
995-1027).

NHWC tensors, as the JAX functions take them:
  * SSIM over 3x3 average-pool windows of reflection-padded inputs, C1 =
    0.01^2, C2 = 0.03^2, returned as (1 - SSIM) / 2 clamped to [0, 1];
  * reprojection loss 0.85 * SSIM + 0.15 * L1, each a mean over channels;
  * automask: a pixel counts where its reprojection loss beats the
    identity reprojection (the caller adds the 1e-5 tie-break noise);
  * edge-aware first-order smoothness of the mean-normalised disparity;
  * the matching mask that distrusts the cost volume where its depth and
    the teacher's differ by more than 100 %.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg_pool3x3_reflect(x):
    """3x3 stride-1 average pool of reflection-padded NHWC input."""
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.avg_pool2d(x, 3, 1).permute(0, 2, 3, 1)


def ssim(x, y):
    """(1 - SSIM) / 2 distance map, the inputs' shape."""
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    mu_x = _avg_pool3x3_reflect(x)
    mu_y = _avg_pool3x3_reflect(y)
    sigma_x = _avg_pool3x3_reflect(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3x3_reflect(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3x3_reflect(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def reprojection_loss(pred, target, no_ssim: bool = False):
    """Per-pixel photometric error [B, H, W, 1]."""
    l1 = torch.abs(target - pred).mean(-1, keepdim=True)
    if no_ssim:
        return l1
    s = ssim(pred, target).mean(-1, keepdim=True)
    return 0.85 * s + 0.15 * l1


def automask(reproj_loss, identity_loss):
    """1 where the reprojection loss is strictly below the identity loss
    (argmin over their concatenation takes the first index on ties)."""
    return (reproj_loss < identity_loss).to(reproj_loss.dtype)


def smooth_loss(disp, img):
    """Edge-aware first-order smoothness (scalar); disp [B, H, W, 1], img
    [B, H, W, C]."""
    grad_disp_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    grad_disp_y = torch.abs(disp[:, :-1] - disp[:, 1:])
    grad_img_x = torch.abs(img[:, :, :-1] - img[:, :, 1:]).mean(-1, keepdim=True)
    grad_img_y = torch.abs(img[:, :-1] - img[:, 1:]).mean(-1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return grad_disp_x.mean() + grad_disp_y.mean()


def normalized_smooth_loss(disp, color, eps: float = 1e-7):
    """Smoothness of the disparity divided by its per-image mean
    (trainer.py:1147-1151)."""
    mean_disp = disp.mean(dim=(1, 2), keepdim=True)
    return smooth_loss(disp / (mean_disp + eps), color)


def matching_mask(mono_depth, lowest_cost_disp):
    """mono_depth [B, H, W, 1], lowest_cost_disp [B, H, W] (1/depth) ->
    [B, H, W, 1]: 1 where the cost volume's depth and the teacher's agree
    within 100 % in both directions."""
    matching_depth = (1.0 / lowest_cost_disp)[..., None]
    mask = ((matching_depth - mono_depth) / mono_depth) < 1.0
    mask &= ((mono_depth - matching_depth) / matching_depth) < 1.0
    return mask.to(mono_depth.dtype)
