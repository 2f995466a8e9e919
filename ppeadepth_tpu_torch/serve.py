"""Inference session: the deployment-facing API (JAX counterpart:
ppeadepth_tpu/serve.py `InferenceSession`).

  session.predict_depth(images)                     teacher depth [B, H, W]
  session.predict_depth_multi(img, lookup, K, invK) student (cost volume) depth
  session.predict_pose(a, b)                        relative pose [B, 4, 4]

Weights come from a state_dict, a checkpoint folder of the port's Trainer,
or a reference `model.pth`, as in the JAX session (serve.py:36-72).

The deploy form is built once: BN folded and the small kernel merged into
the large one (`ckpt.deploy.structural_reparam`), in bf16 every ConvFFN of
both encoders folded into kernel-B operands, conv/linear weights cast to
the compute dtype (the pose nets stay f32). On a CUDA device the large-kernel
convs, ConvFFNs and the plane sweep run the hand-written kernels; on the
CPU they run their plain versions.

Images are float in [0, 1] or uint8, NHWC. Depths are metric after
disp_to_depth with the config's min/max depth.

Under a torch profiler each public call is a `serve.request` span holding its `serve.upload` and `serve.download` spans
(`utils.trace`), and the model's phases inside them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ckpt import io as ckpt_io
from .ckpt.deploy import structural_reparam
from .core.geometry import disp_to_depth
from .models import RepDepth, cast_compute, init_weights
from .utils.trace import span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class InferenceSession:
    """Teacher and student depth serving, and pose.

    opt: `options.Config` (or the JAX package's), or any object with its
    fields that `models.RepDepth` reads plus height, width, min_depth and
    max_depth. The weights come from one of:
      state_dict: the whole RepDepth in training form with the reference's
        names (e.g. from `ckpt.convert.state_dict_from_jax`), loaded with
        strict=True;
      checkpoint: a checkpoint folder of the port's Trainer (`ckpt.io`):
        its model.pth merged by name, and the depth bins of its
        track.json;
      torch_checkpoint: a reference `model.pth`, loaded with strict=True;
    or, with none of them, random weights drawn from `generator` (seed 0
    when None). device: "cuda" unless the caller asks for the CPU.
    min_depth_bin, max_depth_bin: the student's depth-bin range (the JAX
    session's defaults; a checkpoint's track.json replaces them)."""

    def __init__(self, opt, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 *, checkpoint: Optional[str] = None,
                 torch_checkpoint: Optional[str] = None, device="cuda",
                 dtype: str = "bfloat16", merge_reparam: bool = True,
                 generator: Optional[torch.Generator] = None,
                 min_depth_bin: float = 0.1, max_depth_bin: float = 10.0):
        if opt.height % 32 or opt.width % 32:
            raise ValueError(f"height and width must be multiples of 32, got "
                             f"{opt.height}x{opt.width}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.opt = opt
        self.device = torch.device(device)
        self.dtype = _DTYPES[dtype]
        self.min_depth_bin = min_depth_bin
        self.max_depth_bin = max_depth_bin
        if sum(x is not None for x in (state_dict, checkpoint, torch_checkpoint)) > 1:
            raise ValueError("pass at most one of state_dict, checkpoint and "
                             "torch_checkpoint")
        model = RepDepth(opt)
        if torch_checkpoint is not None:
            state_dict = ckpt_io.load_torch_checkpoint(torch_checkpoint)
        elif checkpoint is not None:
            track = ckpt_io.load_model(checkpoint, model)
            self.min_depth_bin = track.get("min_depth_bin", min_depth_bin)
            self.max_depth_bin = track.get("max_depth_bin", max_depth_bin)
            state_dict = model.state_dict()
        elif state_dict is None:
            init_weights(model, generator or torch.Generator().manual_seed(0))
            state_dict = model.state_dict()
        if merge_reparam:
            state_dict = structural_reparam(state_dict)
            model = RepDepth(opt, merged=True)
        model.load_state_dict(state_dict, strict=True)
        model.eval().to(self.device)
        if merge_reparam and self.dtype == torch.bfloat16:
            # kernel B is bf16 only; merged f32 keeps the unfolded ConvFFN,
            # as the JAX package keeps it on lax (ffn_mxu.resolve_ffn_backend)
            model.fold_ffn(self.dtype)
        cast_compute(model, self.dtype)
        self.model = model

    def _images(self, images):
        """NHWC numpy (float in [0, 1] or uint8) -> f32 [B, 3, H, W] on the
        device, an NCHW view of the NHWC bytes."""
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        return x.float().permute(0, 3, 1, 2)

    def _depth(self, disp):
        with span("serve.download"):
            _, depth = disp_to_depth(disp[:, 0].float(), self.opt.min_depth,
                                     self.opt.max_depth)
            return depth.cpu().numpy()

    def predict_depth(self, images) -> np.ndarray:
        """images: [B, H, W, 3] -> metric depth [B, H, W] (float32 numpy)."""
        with span("serve.request"):
            with span("serve.upload"):
                x = self._images(images)
            with torch.inference_mode():
                return self._depth(self.model.forward_mono(x)[("disp", 0)])

    def predict_pose(self, frame_a, frame_b, invert: bool = False) -> np.ndarray:
        """Relative pose from a temporally ordered pair [B, H, W, 3] each ->
        [B, 4, 4] (float32 numpy)."""
        with span("serve.request"):
            with span("serve.upload"):
                a, b = self._images(frame_a), self._images(frame_b)
            with torch.inference_mode():
                T = self.model.pose_pair(a, b, invert)[2]
            with span("serve.download"):
                return T.cpu().numpy()

    def predict_depth_multi(self, images, lookup, K, invK) -> np.ndarray:
        """Student path: current frames and the previous frames [B, H, W, 3]
        each, intrinsics K, invK [B, 4, 4] at the matching (1/4) scale ->
        metric depth [B, H, W] (float32 numpy). The pose lookup->current
        comes from the pose net, inverted, as in the JAX session."""
        with span("serve.request"):
            with span("serve.upload"):
                img, lk = self._images(images), self._images(lookup)
                K, invK = (torch.as_tensor(np.asarray(m), dtype=torch.float32)
                           .to(self.device) for m in (K, invK))
            with torch.inference_mode():
                _, _, T = self.model.pose_pair(lk, img, invert=True)
                out, _, _ = self.model.forward_multi(
                    img, lk[:, None], T[:, None], K, invK, self.min_depth_bin,
                    self.max_depth_bin)
                return self._depth(out[("disp", 0)])
