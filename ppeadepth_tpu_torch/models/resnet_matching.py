"""Legacy ResNet-18 cost-volume matching encoder and Monodepth2 decoder,
the original ManyDepth pair the legacy eval runs (JAX counterpart:
models/resnet_matching.py; reference resnet_encoder.py:75-364 and
depth_decoder.py:15-63).

The module trees are the reference's, so its separate-file checkpoints
(`encoder.pth`, `depth.pth`, `mono_depth.pth`) load with
`load_state_dict(strict=True)` once `eval_depth_ori.legacy_state_dict`
has dropped what the reference saves beside the weights:

  layer0      Sequential(conv1 7x7/2, bn1, ReLU)          -> 1/2 features
  layer1      Sequential(max-pool 3/2/1, resnet layer1)   -> 1/4, C=64
  layer2..4   resnet layers                               -> 1/8 .. 1/32
  reduce_conv Sequential(Conv 3x3 (64 + bins -> 64), ReLU)
  decoder     ModuleList: (upconv i 0, upconv i 1) for i = 4..0, then
              dispconv s for s = 0..3

The plane-sweep volume of the layer-1 features is
`ops.cost_volume.plane_sweep_cost_volume`: kernel C on the card, at f32
C=64 (its [B, 64, H/4, W/4] features in channels_last memory).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import cost_volume as CV
from ..ops.resize import upsample2x_nearest
from .blocks import ConvBlock, Conv3x3
from .resnet import BasicBlock


def _layer(in_ch: int, width: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(in_ch, width, stride),
                         BasicBlock(width, width))


class ResnetEncoderMatching(nn.Module):
    """ResNet-18 with the cost volume spliced in after layer 1."""

    num_ch_enc = (64, 64, 128, 256, 512)

    def __init__(self, num_layers: int = 18, num_depth_bins: int = 96,
                 depth_binning: str = "linear"):
        super().__init__()
        if num_layers != 18:
            raise NotImplementedError(
                f"ResnetEncoderMatching({num_layers}): only ResNet-18 is ported")
        self.num_depth_bins = num_depth_bins
        self.depth_binning = depth_binning
        self.layer0 = nn.Sequential(nn.Conv2d(3, 64, 7, 2, 3, bias=False),
                                    nn.BatchNorm2d(64, eps=1e-5), nn.ReLU())
        self.layer1 = nn.Sequential(nn.MaxPool2d(3, 2, 1), _layer(64, 64, 1))
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(64 + num_depth_bins, 64, 3, padding=1), nn.ReLU())

    def feature_extraction(self, image):
        """image [B, 3, H, W] in [0, 1] -> (layer-0 features at 1/2,
        layer-1 features at 1/4)."""
        f0 = self.layer0((image - 0.45) / 0.225)
        return f0, self.layer1(f0)

    def forward(self, current_image, lookup_images, poses, K, invK,
                min_depth_bin, max_depth_bin):
        """current_image [B, 3, H, W]; lookup_images [B, F, 3, H, W]; poses
        [B, F, 4, 4] current->lookup; K, invK [B, 4, 4] at 1/4 scale;
        min/max_depth_bin scalars. Returns (features [5], lowest_cost
        [B, H/4, W/4], confidence [B, H/4, W/4])."""
        B, F_ = lookup_images.shape[:2]
        f0, cur = self.feature_extraction(current_image)
        with torch.no_grad():
            _, lk = self.feature_extraction(lookup_images.flatten(0, 1))
            lk = lk.reshape(B, F_, *lk.shape[1:])
            bins = CV.compute_depth_bins(
                min_depth_bin, max_depth_bin, self.num_depth_bins,
                self.depth_binning, device=cur.device)
            cost, missing = CV.plane_sweep_cost_volume(
                cur.detach().contiguous(memory_format=torch.channels_last),
                lk, poses.detach(), K, invK, bins)
            conf = CV.confidence_mask(cost, missing)
            lowest_cost = CV.lowest_cost_disparity(cost, bins)
        x = self.reduce_conv(torch.cat([cur, cost * conf[:, None]], 1))
        features = [f0, cur]
        for layer in (self.layer2, self.layer3, self.layer4):
            x = layer(x)
            features.append(x)
        return features, lowest_cost, conf


class DepthDecoder(nn.Module):
    """Monodepth2 decoder: five up-stages with skips, a sigmoid disparity
    at each of `scales` (("disp", s) -> [B, 1, H / 2^s, W / 2^s])."""

    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, num_ch_enc=ResnetEncoderMatching.num_ch_enc,
                 scales=(0, 1, 2, 3), num_output_channels: int = 1,
                 use_skips: bool = True):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        dec = self.num_ch_dec
        convs = []
        for i in range(4, -1, -1):
            in_ch = num_ch_enc[-1] if i == 4 else dec[i + 1]
            convs.append(ConvBlock(in_ch, dec[i]))
            in_ch = dec[i] + (num_ch_enc[i - 1] if use_skips and i > 0 else 0)
            convs.append(ConvBlock(in_ch, dec[i]))
        convs += [Conv3x3(dec[s], num_output_channels) for s in self.scales]
        self.decoder = nn.ModuleList(convs)

    def forward(self, input_features):
        outputs = {}
        x = input_features[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = upsample2x_nearest(self.decoder[2 * k](x))
            if self.use_skips and i > 0:
                x = torch.cat([x, input_features[i - 1]], 1)
            x = self.decoder[2 * k + 1](x)
            if i in self.scales:
                outputs[("disp", i)] = torch.sigmoid(
                    self.decoder[10 + self.scales.index(i)](x))
        return outputs
