"""Device-side augmentation, pyramid and intrinsics of `--fast_pipeline`
(JAX counterpart: data/augment.py, whose semantics this keeps):

  * one colour jitter per item (brightness, contrast, saturation in
    [0.8, 1.2], hue +-0.1 of a turn, in a random order), shared by all of
    the item's frames, applied with probability 1/2; a horizontal flip with
    probability 1/2;
  * blank (all-zero) frames stay zero in color_aug;
  * scale s of the pyramid is the previous scale resized by 2 with
    antialiasing (`jax.image.resize(..., "linear")` on a downscale is the
    triangle filter widened by the factor, which is torch's bilinear with
    `antialias=True`);
  * intrinsics at scale s: K[0] * W / 2^s, K[1] * H / 2^s, and their pinv;
    K is not mirrored under flips, as in the reference.

The random draws are an input (`sample_jitter_factors`), so a test can hand
both packages the same factors. Colours are [B, H, W, 3] f32 tensors
(NHWC), as in the JAX batch dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    diff = maxc - minc
    s = torch.where(maxc > 0, diff / maxc.clamp(min=1e-8), 0.0)
    diff_safe = diff.clamp(min=1e-8)
    rc = (maxc - r) / diff_safe
    gc = (maxc - g) / diff_safe
    bc = (maxc - b) / diff_safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(diff > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def _gray(x):
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def color_jitter(img, factors):
    """img [B, H, W, 3] in [0, 1]; factors: per-item brightness, contrast,
    saturation, hue [B] and order [B, 4] (a permutation of the four ops).
    Each op in the item's order, clipped to [0, 1] after each."""
    def item(v):
        return v.reshape(-1, 1, 1, 1)

    b, c, s = (item(factors[k]) for k in ("brightness", "contrast",
                                           "saturation"))
    hue = factors["hue"].reshape(-1, 1, 1)

    def contrast(x):
        mean = _gray(x).mean(dim=(1, 2), keepdim=True)[..., None]
        return c * x + (1 - c) * mean

    def saturation(x):
        return s * x + (1 - s) * _gray(x)[..., None]

    def hue_shift(x):
        hsv = _rgb_to_hsv(x.clamp(0.0, 1.0))
        h = torch.remainder(hsv[..., 0] + hue, 1.0)
        return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], -1))

    ops = (lambda x: x * b, contrast, saturation, hue_shift)
    x = img
    for k in range(4):
        idx = item(factors["order"][:, k])
        out = ops[3](x)
        for j in (2, 1, 0):
            out = torch.where(idx == j, ops[j](x), out)
        x = out.clamp(0.0, 1.0)
    return x


def sample_jitter_factors(generator: torch.Generator, batch: int,
                          device=None) -> Dict[str, torch.Tensor]:
    """Per-item jitter parameters and the jitter and flip coins, drawn from
    `generator` (on `device`)."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)

    return {
        "brightness": uniform(0.8, 1.2),
        "contrast": uniform(0.8, 1.2),
        "saturation": uniform(0.8, 1.2),
        "hue": uniform(-0.1, 0.1),
        "order": torch.rand((batch, 4), generator=generator,
                            device=device).argsort(dim=1),
        "do_jitter": uniform(0.0, 1.0) > 0.5,
        "do_flip": uniform(0.0, 1.0) > 0.5,
    }


def resize_linear(img, height: int, width: int):
    """[B, H, W, C] -> [B, height, width, C], bilinear with half-pixel
    centres, antialiased on a downscale (`jax.image.resize(..., "linear")`)."""
    x = F.interpolate(img.permute(0, 3, 1, 2), size=(height, width),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def augment_batch(frames: Dict[int, torch.Tensor], K_full: torch.Tensor,
                  factors: Dict[str, torch.Tensor], height: int, width: int,
                  num_scales: int = 4, color_scales: Optional[int] = None
                  ) -> Dict:
    """The training batch dict from full-resolution frames {f: [B, H, W, 3]
    f32 in [0, 1]} and normalised intrinsics K_full [B, 4, 4]:
    ("color" / "color_aug", f, s) for s < color_scales (default
    num_scales) and ("K" / "inv_K", s) for s < num_scales. The training
    step reads the colours of scale 0 only (color_scales=1)."""
    if color_scales is None:
        color_scales = num_scales
    flip = factors["do_flip"].reshape(-1, 1, 1, 1)
    out = {}
    for f, img in frames.items():
        img = torch.where(flip, img.flip(2), img)
        blank = (img.sum(dim=(1, 2, 3)) == 0).reshape(-1, 1, 1, 1)
        use_jit = factors["do_jitter"].reshape(-1, 1, 1, 1) & ~blank
        aug = torch.where(use_jit, color_jitter(img, factors), img)
        aug = torch.where(blank, 0.0, aug)
        cs, as_ = img, aug
        for s in range(color_scales):
            if s:
                h, w = height // 2 ** s, width // 2 ** s
                cs, as_ = resize_linear(cs, h, w), resize_linear(as_, h, w)
            out[("color", f, s)] = cs
            out[("color_aug", f, s)] = torch.where(blank, 0.0, as_)
    for s in range(num_scales):
        K = K_full.clone()
        K[:, 0, :] *= width // 2 ** s
        K[:, 1, :] *= height // 2 ** s
        out[("K", s)] = K
        out[("inv_K", s)] = torch.linalg.pinv(K)
    return out
