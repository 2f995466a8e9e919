"""Typed configuration and CLI with the reference's public flag names (JAX
counterpart: ppeadepth_tpu/options.py, copied so the port imports nothing
of the JAX package).

The reference threads a ~150-flag argparse.Namespace everywhere
(options.py:13-479); the live surface, the flags of the README commands
and the shipped ckpt/models/opt.json, is a frozen dataclass here, and
`parse_args` takes the same CLI names, so `python -m
ppeadepth_tpu_torch.train` accepts the JAX package's (and the reference's)
command lines. The port's modules read fields by name, so a JAX `Config`
works wherever this one does.

Flags that exist for the TPU (its Pallas and XLA backends, and the memory
escape hatches of a 16 GB chip) parse and validate as in the JAX package
and do nothing in the port: `cv_backend`, `warp_backend`, `ffn_backend`,
`lk_deploy_backend`, `lk_train_backend`, `bin_chunk`, `remat_loss`,
`remat_policy`, `remat_pose`, `frozen_bf16`. The port picks its kernels by
the tensors' device. `lk_backend` is honoured: under "pallas" the stem's
stride-1 depthwise conv runs on kernel A too, as the JAX package runs it on
its Pallas kernel (models/replknet.py).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # paths / data
    data_path: str = ""
    log_dir: str = "./ckpt"
    split: str = "eigen_zhou"
    dataset: str = "kitti"
    png: bool = False
    height: int = 192
    width: int = 640
    cs_eval_path: str = "../cityscapes"

    # depth range & frames
    min_depth: float = 0.1
    max_depth: float = 100.0
    frame_ids: Tuple[int, ...] = (0, -1, 1)
    use_future_frame: bool = False
    num_matching_frames: int = 1
    sclm: int = 0  # highest disparity scale used in the loss (live: 0)

    # optimisation
    batch_size: int = 12
    learning_rate: float = 1e-4
    num_epochs: int = 20
    scheduler_step_size: int = 15
    num_workers: int = 12
    pytorch_random_seed: Optional[int] = None

    # loss switches
    disparity_smoothness: float = 1e-3
    no_ssim: bool = False
    disable_automasking: bool = False
    disable_motion_masking: bool = False
    no_matching_augmentation: bool = False
    selec_reproj: bool = False

    # cost volume
    depth_binning: str = "log"
    num_depth_bins: int = 96
    notadabins: bool = False
    cv_min: bool = False
    cv_set_1: bool = False
    cv_pool: bool = False
    dyn_cv: bool = False  # wire match_features_dyn (unwired in reference)
    cv_pool_radius: int = 1
    cv_pool_th: float = 0.7

    # architecture
    adapter: bool = False
    rep_size: str = "b"
    use_checkpoint: bool = False
    adpt_test: int = 4
    ratio: float = 0.25
    g_blk: float = 1.0
    g_ffn: float = 1.0
    trans: bool = False
    input: bool = False
    mono_trans: bool = False
    mono_input: bool = False
    pose_cnn: bool = False
    # "pretrained" (default, like the reference options.py:142-146) makes
    # the Trainer load ImageNet RepLKNet weights into both backbones and
    # a resnet18 state_dict into the pose encoder at init
    # (ckpt/torch_import.bootstrap_pretrained); files missing is an error.
    # "scratch" starts from random init.
    weights_init: str = "pretrained"
    # directory holding RepLKNet-31{B,L}…pth / resnet18*.pth — the
    # reference hardcodes ./pretrained (repdepth.py:84-88)
    backbone_weights: str = "./pretrained"
    num_layers: int = 18

    # stage 2 (dynamic-scene fine-tuning)
    dc: bool = False
    dec_id: int = 1
    dec_ratio: float = 0.25
    train_cs: bool = False
    dec_only: bool = False
    fullft_reb: bool = False
    lps2: bool = False
    ktf: bool = False

    # freezing
    freeze_teacher_and_pose: bool = False
    # accepted for CLI compatibility but REJECTED if changed: the
    # schedule-triggered freeze is commented out in the reference
    # (trainer.py:410-414) and never ran; silently accepting these would
    # let users believe a freeze schedule is in effect
    freeze_teacher_epoch: int = 150
    freeze_teacher_step: int = -1
    freeze_pose: bool = False

    # eval
    eval: bool = False
    eval_split: str = "eigen"
    eval_teacher: bool = False
    zero_cost_volume: bool = False
    static_camera: bool = False
    disable_median_scaling: bool = False
    post_process: bool = False  # Monodepth-v1 flip TTA at eval
    # DDAD eval runs at the reference's forced 320x480
    # (evaluate_ddad.py:251-255) unless this keeps the training resolution
    eval_native_res: bool = False
    pred_depth_scale_factor: float = 1.0
    load_weights_folder: Optional[str] = None
    ddad: bool = False
    # legacy eval (eval_depth_ori equivalent)
    save_pred_disps: bool = False
    no_eval: bool = False
    ext_disp_to_eval: Optional[str] = None

    # logging / checkpoints
    name: str = "test"
    model_name: str = "mdp"
    tags: str = "multi"
    validate_every: int = 3000
    debug: bool = False

    # extras of the JAX package (not in the reference)
    compute_dtype: str = "float32"  # "bfloat16": bf16 compute on f32 params
    # stochastic-depth rate for both RepLKNet encoders; the reference
    # hardcodes 0.3 (repdepth.py:95,106). Exposed so deterministic
    # cross-implementation gradient tests can zero it.
    drop_path_rate: float = 0.3
    lk_backend: str = "lax"          # 'lax' | 'pallas' (the stem on kernel A)
    # TPU backends and memory escape hatches of the JAX package: parsed
    # and validated, no-ops in the port
    bin_chunk: int = 8
    cv_backend: str = "auto"  # auto | lax | mxu | mxu_f32
    warp_backend: str = "auto"  # auto | lax | mxu | mxu_exact
    ffn_backend: str = "auto"  # auto | lax | mxu, or a 4-stage comma list
    lk_deploy_backend: str = "auto"  # auto | lax | banded, or 4 stages
    lk_train_backend: str = "auto"  # auto | lax | banded, or 4 stages
    remat_loss: bool = False
    remat_policy: str = "full"  # full | save_warps
    frozen_bf16: str = "auto"  # auto | on | off
    remat_pose: bool = True
    # gradient accumulation over N microbatches (not ported yet: the
    # Trainer raises for N > 1)
    grad_accum: int = 1
    # native decode + device-side augment, with its decoded-raw epoch
    # cache directory (not ported yet: the Trainer raises)
    fast_pipeline: bool = False
    decode_cache: str = ""
    merged: bool = False             # deploy: reparam-merged LK convs

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def with_mode_presets(self) -> "Config":
        """Runtime mode presets (trainer.py:90-103).

        Deviation from the reference: the reference unconditionally
        forces 192x512 (cs) / 384x640 (ddad); here an EXPLICIT
        --height/--width survives the preset (needed for reduced-size
        tests; the reference's resolutions remain the defaults).
        """
        cfg = self
        default_hw = (Config.height, Config.width)
        if cfg.train_cs:
            cfg = cfg.replace(
                dataset="cityscapes_preprocessed",
                split="cityscapes_preprocessed", eval_split="cityscapes",
            )
            if (cfg.height, cfg.width) == default_hw:
                cfg = cfg.replace(height=192, width=512)
        if cfg.ddad:
            cfg = cfg.replace(
                dataset="ddad", split="ddad", eval_split="ddad",
            )
            if (cfg.height, cfg.width) == default_hw:
                cfg = cfg.replace(height=384, width=640)
        _check(cfg.height % 32 == 0, "'height' must be a multiple of 32")
        _check(cfg.width % 32 == 0, "'width' must be a multiple of 32")
        _check(cfg.cv_backend in ("auto", "lax", "mxu", "mxu_f32"),
               f"unknown --cv_backend {cfg.cv_backend!r}")
        _check(cfg.warp_backend in ("auto", "lax", "mxu", "mxu_exact"),
               f"unknown --warp_backend {cfg.warp_backend!r}")
        ffn_parts = cfg.ffn_backend.split(",")
        _check(len(ffn_parts) in (1, 4) and all(
               p in ("auto", "lax", "mxu") for p in ffn_parts),
               f"unknown --ffn_backend {cfg.ffn_backend!r} "
               "(one of auto|lax|mxu, or a 4-stage comma list)")
        _check(cfg.lk_backend in ("lax", "pallas"),
               f"unknown --lk_backend {cfg.lk_backend!r}")
        lkd_parts = cfg.lk_deploy_backend.split(",")
        _check(len(lkd_parts) in (1, 4) and all(
               p in ("auto", "lax", "banded") for p in lkd_parts),
               f"unknown --lk_deploy_backend {cfg.lk_deploy_backend!r} "
               "(one of auto|lax|banded, or a 4-stage comma list)")
        lkt_parts = cfg.lk_train_backend.split(",")
        _check(len(lkt_parts) in (1, 4) and all(
               p in ("auto", "lax", "banded") for p in lkt_parts),
               f"unknown --lk_train_backend {cfg.lk_train_backend!r} "
               "(one of auto|lax|banded, or a 4-stage comma list)")
        _check(cfg.remat_policy in ("full", "save_warps"),
               f"unknown --remat_policy {cfg.remat_policy!r}")
        _check(cfg.frozen_bf16 in ("auto", "on", "off"),
               f"unknown --frozen_bf16 {cfg.frozen_bf16!r}")
        _check(cfg.weights_init in ("pretrained", "scratch"),
               f"unknown --weights_init {cfg.weights_init!r} "
               "(choices: pretrained, scratch — reference options.py:142-146)")
        _check(cfg.grad_accum >= 1 and cfg.batch_size % cfg.grad_accum == 0,
               f"--batch_size {cfg.batch_size} must be a positive multiple "
               f"of --grad_accum {cfg.grad_accum}")
        if (cfg.freeze_teacher_epoch, cfg.freeze_teacher_step) != (150, -1):
            raise ValueError(
                "--freeze_teacher_epoch/--freeze_teacher_step are dead "
                "flags: the epoch/step-triggered freeze is commented out "
                "in the reference (trainer.py:410-414) and is not "
                "implemented here; use --freeze_teacher_and_pose or "
                "--freeze_pose from the start of the run"
            )
        return cfg

    @property
    def matching_ids(self) -> Tuple[int, ...]:
        ids = [0]
        if self.use_future_frame:
            ids.append(1)
        ids.extend(range(-1, -1 - self.num_matching_frames, -1))
        return tuple(ids)

    @property
    def num_ch_enc(self) -> Tuple[int, ...]:
        from .models.replknet import num_ch_enc

        return num_ch_enc(self.rep_size)


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise ValueError(message)


def _add_flags(p: argparse.ArgumentParser):
    defaults = Config()
    field_names = {g.name for g in dataclasses.fields(Config)}
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            # every bool gets an explicit off switch: default-True flags
            # (e.g. remat_pose) were inexpressible as False from the CLI
            # in rounds 1-3, blocking A/B measurements (VERDICT r3 #4).
            # Exceptions: when no_<name> is itself a reference flag
            # (--no_eval), the primary keeps it and <name> gets no off
            # switch (it is default-False store_true anyway); and fields
            # already named no_* get no --no_no_* double negative.
            g = p.add_mutually_exclusive_group()
            g.add_argument(name, dest=f.name, action="store_true",
                           default=default)
            if ("no_" + f.name not in field_names
                    and not f.name.startswith("no_")):
                g.add_argument("--no_" + f.name, dest=f.name,
                               action="store_false")
        elif f.name == "pytorch_random_seed":
            p.add_argument(name, type=int, default=None)
        elif f.name == "frame_ids":
            p.add_argument(name, nargs="+", type=int, default=list(default))
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def parse_args(argv=None) -> Config:
    p = argparse.ArgumentParser("ppeadepth_tpu_torch")
    _add_flags(p)
    ns = p.parse_args(argv)
    kw = vars(ns)
    kw["frame_ids"] = tuple(kw["frame_ids"])
    return Config(**kw).with_mode_presets()
