"""The one generator of every traffic mix: inputs made from the seed, on
the device where the program takes them there.

A mix file (`traffic/<name>.json`) holds parameters only:
  kind        the loop that drives the program, `loops/<kind>.py`:
              "train_steps" (a training loop, steps back to back) or
              "serve_closed" (one client in a closed loop, sending its
              next request when the last one is answered);
  batch       images a step or a request;
  pool        distinct batches or requests, made once and cycled;
  motion_px   [rows, columns] the camera moves between frames; with
              `vary` the largest, each item drawing its own (rows in
              [-r, r], columns in [1, c]);
  fine_noise  weight of the per-pixel noise over the smooth texture;
  vary        (optional) {"contrast": [lo, hi]}: each item draws its own
              motion and contrast, so the items of a batch differ as a
              real batch's scenes and speeds do;
  mode        (serve) "teacher" (one frame a request) or "student" (the
              current frame and the previous one, with intrinsics);
  check       steps (train) or pool entries (serve) the correctness check
              reads;
  traced      units the `--trace 1` run profiles after the window.

Images are a smooth random texture (bilinear upsampling of 1/8-scale
noise) plus fine noise, and each neighbouring frame is the texture moved
by `motion_px`, so the warps, the pose net and the cost volume see real
motion. KITTI intrinsics, scaled to the image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def intrinsics(batch, height, width, device):
    """KITTI intrinsics scaled to height x width: (K, inv K) [batch, 4, 4]."""
    K = torch.eye(4, device=device)
    K[0, 0], K[1, 1] = 0.58 * width, 1.92 * height
    K[0, 2], K[1, 2] = 0.5 * width, 0.5 * height
    K = K.expand(batch, 4, 4).contiguous()
    return K, torch.linalg.inv(K)


def frames(gen, batch, height, width, motion_px, device, fine_noise=0.2,
           vary=None):
    """{0, -1, +1: [batch, H, W, 3] f32 in [0, 1]}: a texture and the two
    neighbouring frames moved by +-motion_px (see the module's `vary`)."""
    coarse = torch.rand((batch, 3, height // 8, width // 8), generator=gen,
                        device=device)
    base = F.interpolate(coarse, size=(height, width), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    fine = torch.rand((batch, height, width, 3), generator=gen, device=device)
    base = (1 - fine_noise) * base + fine_noise * fine
    if not vary:
        dy, dx = motion_px
        return {0: base.contiguous(),
                -1: torch.roll(base, (dy, dx), (1, 2)).contiguous(),
                1: torch.roll(base, (-dy, -dx), (1, 2)).contiguous()}
    lo, hi = vary["contrast"]
    c = lo + (hi - lo) * torch.rand((batch, 1, 1, 1), generator=gen, device=device)
    base = 0.5 + c * (base - 0.5)
    r, cols = motion_px
    dy = torch.randint(-r, r + 1, (batch,), generator=gen, device=device).tolist()
    dx = torch.randint(1, cols + 1, (batch,), generator=gen, device=device).tolist()
    out = {0: base.contiguous()}
    for f, sign in ((-1, 1), (1, -1)):
        out[f] = torch.stack([torch.roll(base[i], (sign * dy[i], sign * dx[i]), (0, 1))
                              for i in range(batch)])
    return out


def _frames(gen, mix, height, width, device):
    return frames(gen, mix["batch"], height, width, mix["motion_px"], device,
                  mix["fine_noise"], mix.get("vary"))


def train_pool(gen, mix, height, width, device):
    """`pool` training batches (the program's batch dict: colors NHWC f32,
    intrinsics at scales 0 and 2), resident on the device."""
    pool = []
    for _ in range(mix["pool"]):
        fr = _frames(gen, mix, height, width, device)
        b = {}
        for f, img in fr.items():
            b[("color", f, 0)] = b[("color_aug", f, 0)] = img
        for s in (0, 2):
            b[("K", s)], b[("inv_K", s)] = intrinsics(
                mix["batch"], height >> s, width >> s, device)
        pool.append(b)
    return pool


def draws(gen, mix, height, width, device):
    """One step's draws: matching-augmentation uniforms and the two
    automask noises."""
    B = mix["batch"]
    return {"aug_u": torch.rand((B,), generator=gen, device=device),
            "noise_mono": torch.randn((B, height, width, 1), generator=gen,
                                      device=device),
            "noise_multi": torch.randn((B, height, width, 1), generator=gen,
                                       device=device)}


def serve_pool(gen, mix, height, width, device):
    """`pool` requests as a camera gives them: uint8 NHWC numpy frames (the
    current ones, and in student mode the previous ones) and, in student
    mode, 1/4-scale intrinsics as numpy."""
    pool = []
    K, invK = intrinsics(mix["batch"], height // 4, width // 4, device)
    K, invK = K.cpu().numpy(), invK.cpu().numpy()
    for _ in range(mix["pool"]):
        fr = _frames(gen, mix, height, width, device)
        u8 = {f: np.ascontiguousarray(
            (fr[f] * 255).round().to(torch.uint8).cpu().numpy()) for f in (0, -1)}
        if mix["mode"] == "student":
            pool.append((u8[0], u8[-1], K, invK))
        else:
            pool.append((u8[0],))
    return pool
