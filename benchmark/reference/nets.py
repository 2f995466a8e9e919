"""Plain PyTorch reference of PPEA-Depth's networks in training form.

RepLKNet-31B with PEA adapters (adpt_test 4: a zero-padded Conv3x3 - GELU
- Linear block adapter and a Linear - GELU - Linear ConvFFN adapter), the
DepthDecoderV2 with the stage-2 dec_id-1 adapter, the matching encoder
with a ManyDepth plane-sweep cost volume, and the ResNet-18 pose net, as
the PPEA-Depth paper (AAAI 2024) and its code describe them
(YuejiangDong/PPEA-Depth: replknet_adapter.py, depth_decoder_v2.py,
replk_matching.py, resnet_encoder.py, pose_decoder.py, repdepth.py).

Module names follow the upstream checkpoint, so a state_dict of the
measured program loads with strict=True. Every conv, including each
large depthwise kernel, is `F.conv2d`; the cost volume is a gather; the
warp is `F.grid_sample`. Nothing here is merged, folded or packed: eval
mode runs the training form with BN on its running statistics.

`PRECISION["operands"]` set to "fp8" rounds both operands of every conv,
transposed conv and linear layer to float8 e4m3 (one scale per tensor)
before the product: the control of the benchmark's correctness check.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISION = {"operands": "f32"}
_E4M3_MAX = 448.0

REPLK = {
    "b": dict(kernels=(31, 29, 27, 13), layers=(2, 2, 18, 2),
              channels=(128, 256, 512, 1024), small_kernel=5),
    # the tiny width the CPU tests use
    "t": dict(kernels=(7, 7, 5, 3), layers=(1, 1, 2, 1),
              channels=(16, 32, 64, 128), small_kernel=3),
}


class tf32_off:
    """TF32 off for cuDNN and cuBLAS inside the block, the caller's flags
    restored after it: the reference computes in true float32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _q(x):
    """x rounded to float8 e4m3 under one per-tensor scale when the
    control is on; the identity otherwise. Gradients pass straight
    through."""
    if PRECISION["operands"] != "fp8":
        return x
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp(min=1e-12) / _E4M3_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(_q(x), _q(self.weight), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_q(x), _q(self.weight), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(_q(x), _q(self.weight), self.bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class DepthwiseConv(nn.Module):
    """SAME depthwise conv, weight [C, 1, k, k], one `F.conv2d`."""

    def __init__(self, channels, kernel_size, stride=1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size,
                                               kernel_size))

    def forward(self, x):
        k = self.weight.shape[-1]
        return F.conv2d(_q(x), _q(self.weight), None, self.stride, k // 2,
                        groups=x.shape[1])


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, relu=False):
        super().__init__()
        if groups == cin == cout:
            self.conv = DepthwiseConv(cout, k, stride)
        else:
            self.conv = Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                               bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def channel_linear(linear, x):
    return linear(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class DropPath(nn.Module):
    """Per-sample stochastic depth: a mask [B, 1, 1, 1] of 1 / keep or 0,
    drawn by `bernoulli_` from the given generator before the block."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def draw(self, x, generator):
        if not self.training or self.rate == 0.0:
            return None
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0], 1, 1, 1), device=x.device)
        return (mask.bernoulli_(keep, generator=generator) / keep).to(x.dtype)


class ChannelAdapter(nn.Module):
    """Linear(C -> int((C + C_out) / 2 * ratio)) - GELU - Linear(-> C_out)."""

    def __init__(self, channels, ratio=0.25, out_channels=None):
        super().__init__()
        out_channels = out_channels or channels
        hidden = int((channels + out_channels) / 2 * ratio)
        self.D_fc1 = Linear(channels, hidden)
        self.D_fc2 = Linear(hidden, out_channels)

    def forward(self, x):
        return channel_linear(self.D_fc2, F.gelu(channel_linear(self.D_fc1, x)))


class BlockAdapter(nn.Module):
    """adpt_test 4: zero-padded Conv3x3 (C -> C / 4) - GELU - Linear."""

    def __init__(self, channels, ratio=0.25):
        super().__init__()
        hidden = int(channels * ratio)
        self.D_fc1 = Conv2d(channels, hidden, 3, padding=1)
        self.D_fc2 = Linear(hidden, channels)

    def forward(self, x):
        return channel_linear(self.D_fc2, F.gelu(self.D_fc1(x)))


class ReparamLKConv(nn.Module):
    def __init__(self, channels, k, small_k):
        super().__init__()
        self.lkb_origin = ConvBN(channels, channels, k, groups=channels)
        self.small_conv = ConvBN(channels, channels, small_k, groups=channels)

    def forward(self, x):
        return self.lkb_origin(x) + self.small_conv(x)


class RepLKBlock(nn.Module):
    def __init__(self, channels, k, small_k, drop_path):
        super().__init__()
        self.prelkb_bn = nn.BatchNorm2d(channels, eps=1e-5)
        self.adapter = BlockAdapter(channels)
        self.pw1 = ConvBN(channels, channels, 1, relu=True)
        self.large_kernel = ReparamLKConv(channels, k, small_k)
        self.pw2 = ConvBN(channels, channels, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, mask):
        out = self.prelkb_bn(x)
        adpt = self.adapter(out)
        out = self.pw2(F.relu(self.large_kernel(self.pw1(out))))
        if mask is not None:
            out = out * mask
        return x + out + adpt


class ConvFFN(nn.Module):
    def __init__(self, channels, drop_path):
        super().__init__()
        self.preffn_bn = nn.BatchNorm2d(channels, eps=1e-5)
        self.mlp_adapter = ChannelAdapter(channels, 0.25)
        self.pw1 = ConvBN(channels, 4 * channels, 1)
        self.pw2 = ConvBN(4 * channels, channels, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, mask):
        out = self.preffn_bn(x)
        adpt = self.mlp_adapter(out)
        out = self.pw2(F.gelu(self.pw1(out)))
        if mask is not None:
            out = out * mask
        return x + out + adpt


class Stage(nn.Module):
    def __init__(self, channels, n, k, small_k, rates):
        super().__init__()
        blocks = []
        for i in range(n):
            blocks.append(RepLKBlock(channels, k, small_k, rates[i]))
            blocks.append(ConvFFN(channels, rates[i]))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, blk.drop_path.draw(x, generator))
        return x


class RepLKNet(nn.Module):
    """Stem (conv3x3 s2, dw3x3, conv1x1, dw3x3 s2), four stages of
    (RepLKBlock, ConvFFN) pairs, conv1x1 + dw3x3 s2 transitions; drop path
    on the linear schedule over the block pairs."""

    def __init__(self, rep_size, drop_path_rate):
        super().__init__()
        cfg = REPLK[rep_size]
        ch, layers = cfg["channels"], cfg["layers"]
        base = ch[0]
        self.stem = nn.ModuleList([
            ConvBN(3, base, 3, stride=2, relu=True),
            ConvBN(base, base, 3, groups=base, relu=True),
            ConvBN(base, base, 1, relu=True),
            ConvBN(base, base, 3, stride=2, groups=base, relu=True)])
        dpr = np.linspace(0.0, drop_path_rate, sum(layers)).tolist()
        self.stages = nn.ModuleList([
            Stage(ch[i], layers[i], cfg["kernels"][i], cfg["small_kernel"],
                  dpr[sum(layers[:i]):sum(layers[:i + 1])])
            for i in range(4)])
        self.transitions = nn.ModuleList([
            nn.Sequential(ConvBN(ch[i], ch[i + 1], 1, relu=True),
                          ConvBN(ch[i + 1], ch[i + 1], 3, stride=2,
                                 groups=ch[i + 1], relu=True))
            for i in range(3)])

    def forward_stem(self, x):
        for layer in self.stem:
            x = layer(x)
        return x

    def forward(self, x, generator=None):
        x = self.forward_stem(x)
        feats = []
        for i in range(4):
            x = self.stages[i](x, generator)
            feats.append(x)
            if i < 3:
                x = self.transitions[i](x)
        return feats


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Conv3x3(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoderV2(nn.Module):
    """Five nearest-2x up-stages with skips, a sigmoid Conv3x3 head; with
    `dc` the dec_id-1 adapter over concat(feats[0], nearest-8x(feats[3]))
    whose ConvTranspose output, upsampled, joins the last stage."""

    def __init__(self, ch, dc=False, dec_ratio=0.25):
        super().__init__()
        base = ch[0] // 4
        up0, up1, x_ch = [], [], ch[3]
        for i in range(3, -1, -1):
            out = ch[i] // 2
            up0.append(ConvBlock(x_ch, out))
            up1.append(ConvBlock(out + (ch[i - 1] if i > 0 else 0), out))
            x_ch = out
        up0.append(ConvBlock(x_ch, base))
        up1.append(ConvBlock(base, base))
        self.upconvs_0 = nn.ModuleList(up0)
        self.upconvs_1 = nn.ModuleList(up1)
        self.disp_convs = nn.ModuleList([Conv3x3(base, 1)])
        self.dc = dc
        if dc:
            self.adapter = ChannelAdapter(ch[0] + ch[3], dec_ratio,
                                          out_channels=base)
            self.deconv_adpt = ConvTranspose2d(base, base, 3, stride=2,
                                               padding=1, output_padding=1)

    def forward(self, feats):
        adpt = None
        if self.dc:
            x3 = feats[-1]
            up = F.interpolate(x3, size=(8 * x3.shape[2], 8 * x3.shape[3]),
                               mode="nearest")
            adpt = self.deconv_adpt(self.adapter(torch.cat([feats[0], up], 1)))
        x = feats[-1]
        for i in range(4):
            x = upsample2x(self.upconvs_0[i](x))
            if i < 3:
                x = torch.cat([x, feats[2 - i]], 1)
            x = self.upconvs_1[i](x)
        x = self.upconvs_1[4](upsample2x(self.upconvs_0[4](x)))
        if adpt is not None:
            x = x + upsample2x(adpt)
        return {("disp", 0): torch.sigmoid(self.disp_convs[0](x))}


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None
                             else self.downsample(x)))


class _ResNet18(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.conv1 = Conv2d(cin, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        prev = 64
        for i, width in enumerate((64, 128, 256, 512)):
            blocks = [BasicBlock(prev, width, 2 if i else 1),
                      BasicBlock(width, width)]
            prev = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))


class PoseEncoder(nn.Module):
    """ResNet-18 over two frames stacked on channels, input (x - 0.45) /
    0.225; the last level is all the pose decoder reads."""

    def __init__(self):
        super().__init__()
        self.encoder = _ResNet18(6)

    def forward(self, x):
        e = self.encoder
        x = F.relu(e.bn1(e.conv1((x - 0.45) / 0.225)))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
        return x


class PoseDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.ModuleList([Conv2d(512, 256, 1),
                                  Conv2d(256, 256, 3, padding=1),
                                  Conv2d(256, 256, 3, padding=1),
                                  Conv2d(256, 12, 1)])

    def forward(self, x):
        for i, conv in enumerate(self.net):
            x = conv(x)
            if i < 3:
                x = F.relu(x)
        out = 0.01 * x.mean(dim=(2, 3)).reshape(-1, 2, 1, 6)
        return out[..., :3], out[..., 3:]


# ---- geometry ----------------------------------------------------------

def disp_to_depth(disp, min_depth, max_depth):
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    return scaled, 1.0 / scaled


def rot_from_axisangle(vec):
    """Rodrigues' formula, [B, 3] -> [B, 4, 4]."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle)[..., 0], torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis.unbind(-1)
    R = torch.zeros(vec.shape[:-1] + (4, 4), dtype=vec.dtype, device=vec.device)
    R[..., 0, 0] = x * x * C + ca
    R[..., 0, 1] = x * y * C - z * sa
    R[..., 0, 2] = z * x * C + y * sa
    R[..., 1, 0] = x * y * C + z * sa
    R[..., 1, 1] = y * y * C + ca
    R[..., 1, 2] = y * z * C - x * sa
    R[..., 2, 0] = z * x * C - y * sa
    R[..., 2, 1] = y * z * C + x * sa
    R[..., 2, 2] = z * z * C + ca
    R[..., 3, 3] = 1.0
    return R


def transformation_from_parameters(axisangle, translation, invert=False):
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return R @ T if invert else T @ R


def pixel_grid(H, W, device):
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(H * W, device=device)])


def backproject_project(depth, inv_K, K, T, eps=1e-7):
    """depth [B, H, W] -> grid_sample coordinates [B, H, W, 2] of each
    pixel seen from the camera T (Monodepth2's BackprojectDepth then
    Project3D)."""
    B, H, W = depth.shape
    pix = pixel_grid(H, W, depth.device)
    cam = (inv_K[:, :3, :3] @ pix) * depth.reshape(B, 1, -1)
    cam = torch.cat([cam, torch.ones_like(cam[:, :1])], 1)
    P = (K @ T)[:, :3, :]
    p = P @ cam
    pix2 = p[:, :2] / (p[:, 2:3] + eps)
    pix2 = pix2.reshape(B, 2, H, W).permute(0, 2, 3, 1)
    return torch.stack([(pix2[..., 0] / (W - 1) - 0.5) * 2,
                        (pix2[..., 1] / (H - 1) - 0.5) * 2], -1)


# ---- cost volume -------------------------------------------------------

def depth_bins(min_d, max_d, n, device):
    min_d = torch.as_tensor(min_d, dtype=torch.float32, device=device)
    max_d = torch.as_tensor(max_d, dtype=torch.float32, device=device)
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.exp(torch.log(min_d) + torch.log(max_d / min_d) * i / n)


def _sample_zeros(img, x, y):
    """Zeros-padded bilinear sample of img [B, H, W, C] at pixel
    coordinates x, y [B, N] (each corner weighted by its own validity)."""
    B, H, W, C = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.clamp(-2, W).long(), y0.clamp(-2, H).long()
    flat = img.reshape(B, H * W, C)
    items = torch.arange(B, device=img.device)[:, None]

    def at(yi, xi):
        ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(img.dtype)[..., None]
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[items, idx] * ok

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x0i + 1) * wx
    bot = at(y0i + 1, x0i) * (1 - wx) + at(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def plane_sweep(cur, lk, T, K, invK, bins, chunk=8):
    """ManyDepth's cost volume for one lookup frame: for each depth plane,
    warp the lookup features [B, C, H, W] into the current frame, the L1
    difference averaged over channels, zero outside a 2-px edge of the
    sampled position and a 2-px border of the current frame. f32
    [B, D, H, W]."""
    B, C, H, W = cur.shape
    cur = cur.float().permute(0, 2, 3, 1).reshape(B, 1, H * W, C)
    lk = lk.float().permute(0, 2, 3, 1)
    P = (K @ T)[:, :3, :]
    A, t = P[:, :, :3] @ invK[:, :3, :3], P[:, :, 3]
    pix = pixel_grid(H, W, cur.device)
    ys = torch.arange(H, device=cur.device)[:, None]
    xs = torch.arange(W, device=cur.device)[None, :]
    border = ((ys >= 2) & (ys < H - 2) & (xs >= 2) & (xs < W - 2)).float().reshape(-1)
    out = []
    for d0 in range(0, bins.shape[0], chunk):
        b = bins[d0:d0 + chunk]
        cam = (A @ pix)[:, None] * b[None, :, None, None] + t[:, None, :, None]
        z = cam[:, :, 2] + 1e-7
        x, y = cam[:, :, 0] / z, cam[:, :, 1] / z
        warped = _sample_zeros(lk, x.reshape(B, -1), y.reshape(B, -1)
                               ).reshape(B, b.shape[0], H * W, C)
        diff = (warped - cur).abs().mean(-1)
        edge = ((x >= 2) & (x <= W - 2) & (y >= 2) & (y <= H - 2)).float()
        out.append(diff * edge * border)
    return torch.cat(out, 1).reshape(B, -1, H, W)


def cost_volume(cur, lookups, poses, K, invK, bins):
    """Average over the observed lookup frames (all-zero poses skipped),
    missing entries set to the per-pixel max. Returns (cost, missing)."""
    cost = counts = 0
    for f in range(lookups.shape[1]):
        T = poses[:, f]
        d = plane_sweep(cur, lookups[:, f], T, K, invK, bins)
        d = d * (T.abs().sum((1, 2)) > 0).float()[:, None, None, None]
        cost = cost + d
        counts = counts + (d > 0).float()
    cost = cost / (counts + 1e-7)
    missing = (cost == 0).float()
    cost = cost * (1 - missing) + cost.amax(1, keepdim=True) * missing
    return cost, missing


class RepLKMatching(nn.Module):
    def __init__(self, rep_size, num_bins, drop_path_rate):
        super().__init__()
        self.replk = RepLKNet(rep_size, drop_path_rate)
        c0 = REPLK[rep_size]["channels"][0]
        self.reduce_conv = nn.Sequential(Conv2d(c0 + num_bins, c0, 3, padding=1),
                                         nn.ReLU())
        self.num_bins = num_bins

    def features(self, x, generator):
        return self.replk.stages[0](self.replk.forward_stem(x), generator)

    def forward(self, image, lookups, poses, K, invK, min_bin, max_bin,
                generator=None):
        B, F_ = lookups.shape[:2]
        cur = self.features(image, generator)
        with torch.no_grad():
            lk = self.features(lookups.flatten(0, 1), generator)
            lk = lk.reshape(B, F_, *lk.shape[1:])
            bins = depth_bins(min_bin, max_bin, self.num_bins, cur.device)
            cost, missing = cost_volume(cur.detach(), lk, poses.detach().float(),
                                        K, invK, bins)
            conf = ((cost * (1 - missing)) > 0).sum(1).eq(cost.shape[1]).float()
            lowest = 1.0 / bins[torch.argmin(torch.where(cost == 0, 100.0, cost), 1)]
        x = self.reduce_conv(torch.cat([cur, cost * conf[:, None]], 1))
        feats = [cur]
        for i in range(1, 4):
            x = self.replk.stages[i](self.replk.transitions[i - 1](x), generator)
            feats.append(x)
        return feats, lowest, conf


class RepDepth(nn.Module):
    """Teacher (`mono_encoder` + `mono_depth`), student (`encoder` +
    `depth`) and pose net (`pose_encoder` + `pose`)."""

    def __init__(self, cfg):
        super().__init__()
        o = cfg["options"]
        if not o.get("adapter") or o.get("adpt_test", 4) != 4:
            raise ValueError("the reference holds adpt_test 4 adapters only")
        if o.get("dc") and o.get("dec_id", 1) != 1:
            raise ValueError("the reference holds the dec_id-1 decoder only")
        self.cfg = cfg
        rate = o.get("drop_path_rate", 0.3)
        rep = o.get("rep_size", "b")
        ch = REPLK[rep]["channels"]
        self.encoder = RepLKMatching(rep, o.get("num_depth_bins", 96), rate)
        self.depth = DepthDecoderV2(ch, o.get("dc", False))
        self.mono_encoder = RepLKNet(rep, rate)
        self.mono_depth = DepthDecoderV2(ch, o.get("dc", False))
        self.pose_encoder = PoseEncoder()
        self.pose = PoseDecoder()

    def forward_mono(self, image, generator=None):
        return self.mono_depth(self.mono_encoder(image, generator))

    def pose_pair(self, a, b, invert=False):
        axisangle, translation = self.pose(self.pose_encoder(torch.cat([a, b], 1)))
        T = transformation_from_parameters(axisangle[:, 0, 0],
                                           translation[:, 0, 0], invert)
        return axisangle, translation, T

    def forward_multi(self, image, lookups, poses, K, invK, min_bin, max_bin,
                      generator=None):
        feats, lowest, conf = self.encoder(image, lookups, poses, K, invK,
                                           min_bin, max_bin, generator)
        return self.depth(feats), lowest, conf
