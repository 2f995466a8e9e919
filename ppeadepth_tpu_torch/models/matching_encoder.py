"""Multi-frame matching encoder: RepLKNet with a plane-sweep cost volume
spliced in after stage 0 (JAX counterpart: models/matching_encoder.py
`RepLKMatching`; reference replk_matching.py:251-302).

  current feats = stem + stage 0 of the current image
  lookup feats  = stem + stage 0 of the lookup frames (a second pass)
  cost volume   = plane sweep over `num_depth_bins` hypotheses on the
                  features (kernel C), confidence mask, lowest-cost
                  disparity
  fusion        = ReLU(Conv3x3(concat(current feats, cost * confidence)))
                  (`reduce_conv`)
  resume        = transitions + stages 1..3 for the 4-level pyramid

In training the lookup features are gradient-free (computed under
`torch.no_grad()`, BN statistics still updated, replk_matching.py:265-281)
and the cost volume is built on detached f32 features. Under `dyn`
(`--dyn_cv`) the DynamicDepth volume (`ops.cost_volume.
plane_sweep_cost_volume_dyn`, plain torch as JAX keeps it on lax) takes
kernel C's place: it fills in the occluded entries of the warped features
from the full-resolution lookup images.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import cost_volume as CV
from .replknet import RepLKNet


class RepLKMatching(nn.Module):
    def __init__(self, rep_size: str = "b", adpt_test: int = -1,
                 g_blk: float = 1.0, g_ffn: float = 1.0, ratio: float = 0.25,
                 trans_adpt: bool = False, input_adpt: bool = False,
                 merged: bool = False, num_depth_bins: int = 96,
                 depth_binning: str = "log", drop_path_rate: float = 0.0,
                 use_checkpoint: bool = False, lk_backend: str = "lax"):
        super().__init__()
        self.replk = RepLKNet(
            rep_size=rep_size, adpt_test=adpt_test, g_blk=g_blk, g_ffn=g_ffn,
            ratio=ratio, trans_adpt=trans_adpt, input_adpt=input_adpt,
            merged=merged, drop_path_rate=drop_path_rate,
            use_checkpoint=use_checkpoint, lk_backend=lk_backend)
        c0 = self.replk.stem[0].conv.out_channels
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(c0 + num_depth_bins, c0, 3, padding=1), nn.ReLU())
        self.num_depth_bins = num_depth_bins
        self.depth_binning = depth_binning

    def feature_extraction(self, image, generator=None):
        """stem + stage 0 -> features at 1/4 resolution."""
        return self.replk.forward_stage(0, self.replk.forward_stem(image),
                                        generator)

    def forward(self, current_image, lookup_images, poses, K, invK,
                min_depth_bin, max_depth_bin, generator=None, aug_mask=None,
                dyn: bool = False, cv_min: bool = False,
                cv_set_1: bool = False, cv_pool: bool = True,
                cv_pool_radius: int = 1, cv_pool_th: float = 0.7):
        """current_image: [B, 3, H, W]; lookup_images: [B, F, 3, H, W];
        poses: [B, F, 4, 4] current->lookup; K, invK: [B, 4, 4] at 1/4
        (matching) scale; min/max_depth_bin: scalars or 0-d tensors;
        generator: draws the drop-path masks in training. `dyn` and the
        `cv_*` options select and configure the DynamicDepth volume;
        aug_mask [B, 1, 1, 1] (zeros when None) gates its in-fill off for
        matching-augmented items.

        Returns (features[4], lowest_cost [B, H/4, W/4],
        confidence [B, H/4, W/4])."""
        B, F_ = lookup_images.shape[:2]
        cur = self.feature_extraction(current_image, generator)
        with torch.no_grad():
            lk = self.feature_extraction(lookup_images.flatten(0, 1), generator)
            lk = lk.reshape(B, F_, *lk.shape[1:])
            # f32 geometry: outside any bf16 autocast region
            with torch.autocast(cur.device.type, enabled=False):
                bins = CV.compute_depth_bins(
                    min_depth_bin, max_depth_bin, self.num_depth_bins,
                    self.depth_binning, device=cur.device)
                if dyn:
                    if aug_mask is None:
                        aug_mask = torch.zeros((B, 1, 1, 1), device=cur.device)
                    cost, missing = CV.plane_sweep_cost_volume_dyn(
                        cur.detach(), lk, poses.detach(), K, invK, bins,
                        lookup_images.detach().float(), aug_mask.detach(),
                        cv_min=cv_min, set_1=cv_set_1, pool=cv_pool,
                        pool_r=cv_pool_radius, pool_th=cv_pool_th)
                else:
                    cost, missing = CV.plane_sweep_cost_volume(
                        cur.detach(), lk, poses.detach(), K, invK, bins)
                conf = CV.confidence_mask(cost, missing)
                lowest_cost = CV.lowest_cost_disparity(cost, bins)

        x = torch.cat([cur, (cost * conf[:, None]).to(cur.dtype)], 1)
        x = self.reduce_conv(x.to(dtype=self.reduce_conv[0].weight.dtype,
                                  memory_format=torch.channels_last))
        features = [cur]
        for i in range(1, 4):
            x = self.replk.forward_transition(i - 1, x, generator)
            x = self.replk.forward_stage(i, x, generator)
            features.append(x)
        return features, lowest_cost, conf
