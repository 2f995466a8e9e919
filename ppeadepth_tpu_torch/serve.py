"""Inference session: the deployment-facing API (JAX counterpart:
ppeadepth_tpu/serve.py `InferenceSession`).

  session.predict_depth(images)      teacher depth [B, H, W]

The deploy form is built once: BN folded and the small kernel merged into
the large one (`ckpt.deploy.structural_reparam`), every ConvFFN folded into
kernel-B operands, conv/linear weights cast to the compute dtype. On a CUDA
device the large-kernel convs and ConvFFNs run the hand-written kernels
(bf16 only); on the CPU they run their plain versions.

Images are float in [0, 1] or uint8, NHWC. Depths are metric after
disp_to_depth with the config's min/max depth.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ckpt.deploy import structural_reparam
from .core.geometry import disp_to_depth
from .models import RepDepth, cast_compute, init_weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class InferenceSession:
    """Teacher depth serving.

    opt: `ppeadepth_tpu.options.Config`, or any object with its fields that
    `models.RepDepth` reads plus height, width, min_depth and max_depth.
    state_dict: the model in training
    form with the reference's names (e.g. from `ckpt.convert.
    state_dict_from_jax`); None draws random weights from `generator`
    (seed 0 when None)."""

    def __init__(self, opt, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 *, device, dtype: str = "bfloat16", merge_reparam: bool = True,
                 generator: Optional[torch.Generator] = None):
        if opt.height % 32 or opt.width % 32:
            raise ValueError(f"height and width must be multiples of 32, got "
                             f"{opt.height}x{opt.width}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.opt = opt
        self.device = torch.device(device)
        self.dtype = _DTYPES[dtype]
        model = RepDepth(opt)
        if state_dict is None:
            init_weights(model, generator or torch.Generator().manual_seed(0))
            state_dict = model.state_dict()
        if merge_reparam:
            state_dict = structural_reparam(state_dict)
            model = RepDepth(opt, merged=True)
        model.load_state_dict(state_dict, strict=True)
        model.eval().to(self.device)
        if merge_reparam:
            model.mono_encoder.fold_ffn(self.dtype)
        cast_compute(model, self.dtype)
        self.model = model

    def predict_depth(self, images) -> np.ndarray:
        """images: [B, H, W, 3] -> metric depth [B, H, W] (float32 numpy)."""
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = x.float().permute(0, 3, 1, 2)  # NCHW view of NHWC bytes
        with torch.inference_mode():
            disp = self.model.forward_mono(x)[("disp", 0)][:, 0].float()
            _, depth = disp_to_depth(disp, self.opt.min_depth,
                                     self.opt.max_depth)
        return depth.cpu().numpy()
