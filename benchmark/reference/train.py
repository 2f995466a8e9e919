"""Plain PyTorch reference of one PPEA-Depth training step: both branches'
forward passes, the Monodepth2 / ManyDepth photometric losses, the
backward pass into the trainable set, Adam, and the depth-bin EMA
(upstream trainer.py and repdepth.py of YuejiangDong/PPEA-Depth).

A batch is a dict of f32 tensors on one device: ("color", f, 0) and
("color_aug", f, 0) as [B, H, W, 3] for f in (0, -1, 1), ("K", s) and
("inv_K", s) as [B, 4, 4] for s in (0, 2). A step's draws are the
matching-augmentation uniforms `aug_u` [B] and the automask noise
`noise_mono` and `noise_multi` [B, H, W, 1]; the drop-path masks come from
a generator that the steps share.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nets

FRAMES = (0, -1, 1)


def trainable(name: str, options: dict) -> bool:
    """The upstream freezing rule: encoders train their adapters, BN and
    (student) the fusion conv; stage 1 trains the decoders and pose net,
    stage 2 (`dc`) only the decoders' adapters and the pose net."""
    top = name.split(".")[0]
    if top in ("encoder", "mono_encoder"):
        keys = ("adpt", "adapter", "bn") + (("reduce",) if top == "encoder" else ())
        return any(k in name for k in keys)
    if top in ("depth", "mono_depth") and options.get("dc"):
        return "adpt" in name or "adapter" in name
    return True


# ---- losses --------------------------------------------------------------

def _pool3(x):
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.avg_pool2d(x, 3, 1).permute(0, 2, 3, 1)


def ssim(x, y):
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mx, my = _pool3(x), _pool3(y)
    sx = _pool3(x * x) - mx * mx
    sy = _pool3(y * y) - my * my
    sxy = _pool3(x * y) - mx * my
    n = (2 * mx * my + C1) * (2 * sxy + C2)
    d = (mx ** 2 + my ** 2 + C1) * (sx + sy + C2)
    return torch.clamp((1 - n / d) / 2, 0, 1)


def reprojection(pred, target):
    l1 = (target - pred).abs().mean(-1, keepdim=True)
    return 0.85 * ssim(pred, target).mean(-1, keepdim=True) + 0.15 * l1


def smoothness(disp, img):
    disp = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
    gx = (disp[:, :, :-1] - disp[:, :, 1:]).abs()
    gy = (disp[:, :-1] - disp[:, 1:]).abs()
    ix = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True)
    iy = (img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True)
    return (gx * torch.exp(-ix)).mean() + (gy * torch.exp(-iy)).mean()


def _warp(img, coords):
    """Border-padded bilinear warp of NHWC img at grid coordinates."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), coords, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _branch(batch, out, o, noise, multi: bool):
    disp = out[("disp", 0)]
    _, depth = nets.disp_to_depth(disp[:, 0], o["min_depth"], o["max_depth"])
    target = batch[("color", 0, 0)]
    reproj = []
    for f in FRAMES[1:]:
        T = out[("cam_T_cam", 0, f)]
        coords = nets.backproject_project(
            depth, batch[("inv_K", 0)], batch[("K", 0)], T.detach() if multi else T)
        reproj.append(reprojection(_warp(batch[("color", f, 0)], coords), target))
    reproj = torch.cat(reproj, -1).amin(-1, keepdim=True)
    depth = depth[..., None]
    extra = 0.0
    if multi:
        mask = out["consistency_mask"][..., None] * (1.0 - out["augmentation_mask"])
        extra = ((depth - out["mono_depth"].detach()).abs() * (1.0 - mask)).mean()
    else:
        identity = torch.cat([reprojection(batch[("color", f, 0)], target)
                              for f in FRAMES[1:]], -1).amin(-1, keepdim=True)
        mask = (reproj < identity + noise * 1e-5).float()
    reproj_loss = (reproj * mask).sum() / (mask.sum().detach() + 1e-7)
    smooth = smoothness(disp.permute(0, 2, 3, 1), target)
    return reproj_loss + extra + o["disparity_smoothness"] * smooth, depth


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def losses(model, batch, min_bin, max_bin, draws, gen):
    """(total loss, teacher depth [B, H, W, 1]) of one batch; `gen` draws
    the drop-path masks."""
    o = model.cfg["options"]
    img = {f: _nchw(batch[("color_aug", f, 0)]) for f in FRAMES}
    poses = {}
    for f in FRAMES[1:]:
        pair = (img[f], img[0]) if f < 0 else (img[0], img[f])
        _, _, poses[("cam_T_cam", 0, f)] = model.pose_pair(*pair, invert=f < 0)
    with torch.no_grad():
        rel = model.pose_pair(img[-1], img[0], invert=True)[2]
        blank = img[-1].sum(dim=(1, 2, 3)) == 0
        rel = torch.where(blank[:, None, None], torch.zeros_like(rel), rel)
    lookup, rel = img[-1][:, None], rel[:, None]
    u = draws["aug_u"]
    static, zero = u < 0.25, (u >= 0.25) & (u < 0.5)
    lookup = torch.where(static[:, None, None, None, None],
                         _nchw(batch[("color", 0, 0)])[:, None], lookup)
    rel = torch.where(zero[:, None, None, None], torch.zeros_like(rel), rel)
    aug_mask = (static | zero).float().reshape(-1, 1, 1, 1)

    mono = dict(poses)
    mono.update(model.forward_mono(img[0], gen))
    out, lowest, conf = model.forward_multi(img[0], lookup, rel, batch[("K", 2)],
                                            batch[("inv_K", 2)], min_bin,
                                            max_bin, gen)
    out.update(poses)
    H, W = img[0].shape[-2:]
    lowest = F.interpolate(lowest[:, None], size=(H, W), mode="nearest")[:, 0]
    conf = F.interpolate(conf[:, None], size=(H, W), mode="nearest")[:, 0]
    out["augmentation_mask"] = aug_mask

    mono_loss, mono_depth = _branch(batch, mono, o, draws["noise_mono"], False)
    md = mono_depth.detach()
    match = 1.0 / lowest[..., None]
    agree = (((match - md) / md) < 1.0) & (((md - match) / match) < 1.0)
    out["consistency_mask"] = conf * agree[..., 0].float()
    out["mono_depth"] = mono_depth
    multi_loss, _ = _branch(batch, out, o, draws["noise_multi"], True)
    return multi_loss + mono_loss, mono_depth, (mono_loss, multi_loss)


class Trainer:
    """The reference step on `model` (nets.RepDepth, train mode) with
    plain Adam over the trainable parameters."""

    def __init__(self, model, lr, drop_path_seed):
        self.model = model
        self.params = {n: p for n, p in model.named_parameters()
                       if trainable(n, model.cfg["options"])}
        for n, p in model.named_parameters():
            p.requires_grad_(n in self.params)
        self.opt = torch.optim.Adam(self.params.values(), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        dev = next(model.parameters()).device
        self.min_bin = torch.tensor(0.1, device=dev)
        self.max_bin = torch.tensor(10.0, device=dev)
        self.gen = torch.Generator(dev).manual_seed(drop_path_seed)

    def step(self, batch, draws):
        """One step; returns (loss, {name: gradient norm}, (teacher loss,
        student loss))."""
        o = self.model.cfg["options"]
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        total, depth, parts = losses(self.model, batch, self.min_bin,
                                     self.max_bin, draws, self.gen)
        total.backward()
        grads = {n: p.grad.detach().norm() for n, p in self.params.items()
                 if p.grad is not None}
        self.opt.step()
        d = depth.detach()
        dmin = torch.clamp(d.amin(dim=(1, 2, 3)).mean() * 0.9, min=o["min_depth"])
        dmax = d.amax(dim=(1, 2, 3)).mean()
        self.min_bin = self.min_bin * 0.99 + dmin * 0.01
        self.max_bin = self.max_bin * 0.99 + dmax * 1.1 * 0.01
        return total.detach(), grads, tuple(p.detach() for p in parts)
