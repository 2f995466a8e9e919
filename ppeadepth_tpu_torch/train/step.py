"""The stage-1 training step: forward of both branches, photometric losses,
backward into the trainable parameters, Adam, and the depth-bin EMA (JAX
counterpart: train/step.py, `create_train_state` :89, `_warp_frames` :105,
`_branch_losses` :162, `make_loss_fn` :250, `make_train_step` :354).

Loss semantics (trainer.py:420-472, 871-926, 1032-1160):
  * teacher branch: min-reprojection over frames -1 and +1, automask
    against the min identity reprojection plus the 1e-5 tie-break noise,
    edge-aware smoothness of the mean-normalised disparity;
  * student branch: poses detached, reprojection masked by the
    consistency mask (times the matching mask against the detached teacher
    depth) and by 1 - augmentation mask, plus the consistency loss
    |student depth - teacher depth| on the masked-out pixels;
  * the teacher's loss joins the total unless teacher and pose are frozen;
  * depth bins: per-sample min/max of the teacher depth, batch mean,
    widened x0.9 / x1.1, EMA 0.99 (trainer.py:41-69).

Where the JAX state is one pytree, the port keeps it where PyTorch does:
parameters, BN statistics and requires_grad in the model, Adam's moments
in the optimizer, the step count, depth bins and generator in
`TrainState`. The warps run through kernel D (`kernels.warp.warp_border`,
one launch per branch with the frames stacked on the batch axis, as JAX
does), the large-kernel convs through kernel #2
(`kernels.lk_conv.lk_depthwise_train`).

`--grad_accum N` (JAX `stack_microbatches` :338 and the scan :385-420)
runs N microbatches, microbatch i the strided samples i::N, each with its
own draws: a forward and a backward each, their gradients summed in
`.grad` and divided by N once (JAX sums, then divides), BN running
statistics updated once per microbatch in order, the metrics and the
teacher depth's min/max averaged over the microbatches; Adam, the
schedule and the bin EMA step once.

Under data parallelism (`parallel.dist`, one process a device) the step
is the JAX step over the global batch: each rank holds its rows of the
batch, the draws are made for the global batch and sliced
(`dist.rank_rows`), BN takes global statistics (`dist.GlobalBatchNorm`,
swapped in by the caller), the reprojection losses divide by the
global mask count, the gradients are averaged over the ranks before
Adam, and the metrics and the depth extremes of the bin update are the
global batch's. The batch handed to the step is this rank's share.

Options the JAX package needs to fit 16 GB of HBM (`remat_loss`,
`remat_policy`, `remat_pose`, `frozen_bf16`) are accepted and do nothing
here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import losses as L
from ..core.geometry import disp_to_depth, reproject_coords
from ..kernels.warp import warp_border
from ..ops.resize import resize_bilinear
from ..parallel import dist
from ..utils.trace import span
from .freeze import apply_labels, param_labels

_COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    """The step count, the adaptive depth-bin range (0-d f32 tensors on
    the device) and the generator of the step's random draws."""
    step: int
    min_depth_bin: torch.Tensor
    max_depth_bin: torch.Tensor
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.min_depth_bin.device


@dataclass
class StepDraws:
    """What the JAX step draws from its key (step.py:287): the drop-path
    generator (None: torch's default), the matching-augmentation uniforms
    `aug_u` [B], and the automask noise [B, H, W, 1] of the teacher
    (`noise_mono`) and student (`noise_multi`) branches (unit normal; the
    loss scales it by 1e-5)."""
    aug_u: torch.Tensor
    noise_mono: torch.Tensor
    noise_multi: torch.Tensor
    drop_path: Optional[torch.Generator] = None


def draw(generator: torch.Generator, batch: int, height: int, width: int
         ) -> StepDraws:
    """A step's draws from `generator` (on the step's device)."""
    dev = generator.device

    def normal():
        return torch.randn((batch, height, width, 1), generator=generator,
                           device=dev)

    return StepDraws(aug_u=torch.rand((batch,), generator=generator, device=dev),
                     noise_mono=normal(), noise_multi=normal(),
                     drop_path=generator)


def rank_draws(d: StepDraws) -> StepDraws:
    """This rank's rows of draws made for the global (micro)batch."""
    return StepDraws(aug_u=dist.rank_rows(d.aug_u),
                     noise_mono=dist.rank_rows(d.noise_mono),
                     noise_multi=dist.rank_rows(d.noise_multi),
                     drop_path=d.drop_path)


def create_train_state(model, opt, *, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """Move `model` to `device` in train mode, freeze it by
    `freeze.param_labels` (requires_grad), and start the state: step 0,
    depth bins 0.1 / 10 (DepthBins defaults, trainer.py:45-46).
    `generator` (on `device`; seed 0 when None) draws each step's
    randomness unless the caller hands the draws in."""
    device = torch.device(device)
    model.to(device).train()
    apply_labels(model, param_labels(model, opt))
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return TrainState(
        step=0,
        min_depth_bin=torch.tensor(0.1, device=device),
        max_depth_bin=torch.tensor(10.0, device=device),
        generator=generator)


def split_microbatches(inputs: Dict, n: int) -> List[Dict]:
    """The n microbatches of a batch dict: microbatch i takes the strided
    samples i::n of every entry (JAX `stack_microbatches`), as contiguous
    tensors; the batch itself when n is 1."""
    if n == 1:
        return [inputs]
    return [{k: v[i::n].contiguous() for k, v in inputs.items()}
            for i in range(n)]


def batch_to_device(batch: Dict, device) -> Dict:
    """The JAX batch dict (numpy arrays or tensors; colors NHWC) as f32
    tensors on `device`."""
    return {k: (v if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, dtype=np.float32))
                ).to(device=device, dtype=torch.float32)
            for k, v in batch.items()}


def _warp_frames(inputs, depth, poses, opt, is_multi: bool):
    """Inverse-warp the neighbour frames into frame 0 (trainer.py:894-914):
    one kernel-D call for the branch, the frames stacked on the batch axis.
    depth [B, H, W, 1]; returns {f: [B, H, W, 3]}."""
    K, invK = inputs[("K", 0)], inputs[("inv_K", 0)]
    frames = list(opt.frame_ids[1:])
    coords = []
    for f in frames:
        T = poses[("cam_T_cam", 0, f)]
        if is_multi:
            T = T.detach()  # trainer.py:899-901
        coords.append(reproject_coords(depth, invK, K, T))
    out = warp_border(torch.cat([inputs[("color", f, 0)] for f in frames]),
                      torch.cat(coords).contiguous())
    return dict(zip(frames, out.chunk(len(frames))))


def _branch_losses(inputs, outputs, opt, noise, is_multi: bool):
    """Scale-0 losses of one branch: (loss, aux, depth [B, H, W, 1])."""
    disp = outputs[("disp", 0)]
    disp_full = resize_bilinear(disp, opt.height, opt.width).permute(0, 2, 3, 1)
    _, depth = disp_to_depth(disp_full, opt.min_depth, opt.max_depth)

    warped = _warp_frames(inputs, depth, outputs, opt, is_multi)
    target = inputs[("color", 0, 0)]
    reproj = torch.cat([L.reprojection_loss(warped[f], target, opt.no_ssim)
                        for f in opt.frame_ids[1:]], -1)
    reproj_min = reproj.amin(-1, keepdim=True)

    if opt.selec_reproj:
        # a warp hole (all-black warped frame) takes the other frame's
        # loss; both black -> 0 (trainer.py:1077-1083)
        m_m1 = warped[opt.frame_ids[1]].sum(-1, keepdim=True) < 0.1
        m_p1 = warped[opt.frame_ids[2]].sum(-1, keepdim=True) < 0.1
        reproj_min = torch.where(m_m1, reproj[..., 1:2], reproj_min)
        reproj_min = torch.where(m_p1, reproj[..., 0:1], reproj_min)
        reproj_min = torch.where(m_m1 & m_p1, torch.zeros_like(reproj_min),
                                 reproj_min)

    if not opt.disable_automasking and not is_multi:
        identity = torch.cat([L.reprojection_loss(inputs[("color", f, 0)],
                                                  target, opt.no_ssim)
                              for f in opt.frame_ids[1:]], -1)
        identity_min = identity.amin(-1, keepdim=True) + noise * 1e-5
        mask = L.automask(reproj_min, identity_min)
    else:
        mask = torch.ones_like(reproj_min)

    aux = {}
    consistency_loss = 0.0
    if is_multi:
        # the student replaces the automask (trainer.py:1101-1121)
        mask = torch.ones_like(mask)
        if not opt.disable_motion_masking:
            mask = mask * outputs["consistency_mask"][..., None]
        if not opt.no_matching_augmentation:
            mask = mask * (1.0 - outputs["augmentation_mask"])
        mono_depth = outputs[("mono_depth", 0, 0)].detach()
        consistency_loss = torch.mean(torch.abs(depth - mono_depth) * (1.0 - mask))
        aux["consistency_loss"] = consistency_loss

    # the global batch's mask count; each rank's share of the sum, scaled
    # by the world size, so the mean over ranks is the global ratio
    count = dist.all_reduce_sum_(torch.sum(mask).detach())
    reproj_loss = dist.world() * torch.sum(reproj_min * mask) / (count + 1e-7)
    smooth = L.normalized_smooth_loss(disp.permute(0, 2, 3, 1), target)
    loss = reproj_loss + consistency_loss + opt.disparity_smoothness * smooth
    aux["reproj_loss"] = reproj_loss
    aux["smooth_loss"] = smooth
    return loss, aux, depth


def _model_inputs(inputs, opt):
    """The model's view of the batch: colors as [B, 3, H, W] views of the
    NHWC bytes, the 1/4-scale intrinsics."""
    ids = set(opt.frame_ids) | set(opt.matching_ids)
    out = {(kind, f, 0): inputs[(kind, f, 0)].permute(0, 3, 1, 2)
           for kind in ("color", "color_aug") for f in ids
           if (kind, f, 0) in inputs}
    out[("K", 2)], out[("inv_K", 2)] = inputs[("K", 2)], inputs[("inv_K", 2)]
    return out


def make_loss_fn(model, opt):
    """loss_fn(inputs, min_bin, max_bin, draws) -> (total, metrics,
    teacher depth [B, H, W, 1]): the full forward of both branches and
    their losses. `inputs` is the batch on the device (`batch_to_device`);
    the model computes in `opt.compute_dtype` under autocast, the losses
    in f32."""
    freeze_tp = opt.freeze_teacher_and_pose
    compute = _COMPUTE[opt.compute_dtype]

    def loss_fn(inputs, min_bin, max_bin, draws: StepDraws):
        dev = min_bin.device
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=compute == torch.bfloat16):
            mono_outputs, outputs = model.forward_train(
                _model_inputs(inputs, opt), min_bin, max_bin, draws.aug_u,
                freeze_tp=freeze_tp, freeze_pose=opt.freeze_pose,
                generator=draws.drop_path)
        with span("train.losses"):
            mono_loss, mono_aux, mono_depth = _branch_losses(
                inputs, mono_outputs, opt, draws.noise_mono, False)
            # the student sees the teacher's depth (trainer.py:443-451, 859-869)
            outputs[("mono_depth", 0, 0)] = mono_depth
            outputs["consistency_mask"] = outputs["consistency_mask"] * L.matching_mask(
                mono_depth.detach(), outputs["lowest_cost"])[..., 0]
            multi_loss, multi_aux, _ = _branch_losses(
                inputs, outputs, opt, draws.noise_multi, True)
        total = multi_loss if freeze_tp else multi_loss + mono_loss
        metrics = {
            "loss": total,
            "mono/loss": mono_loss,
            "mono/reproj": mono_aux["reproj_loss"],
            "multi/loss": multi_loss,
            "multi/reproj": multi_aux["reproj_loss"],
            "multi/consistency": multi_aux["consistency_loss"],
        }
        return total, metrics, mono_depth

    return loss_fn


def make_train_step(model, opt, optimizer, scheduler=None):
    """train_step(state, batch, draws=None) -> (state, metrics).

    batch: the JAX batch dict (`("color", f, 0)`, `("color_aug", f, 0)`
    NHWC, `("K", s)`, `("inv_K", s)`) of the whole step (this rank's share
    under data parallelism); draws: one `StepDraws` per microbatch
    (`opt.grad_accum` of them, a bare StepDraws when there is one), each
    made for the global microbatch, or None to draw them in order from
    `state.generator`. One update of `optimizer` (and `scheduler`, e.g.
    `schedule.make_optimizer`'s LambdaLR); gradients stay in the
    parameters' `.grad` until the next step. metrics: 0-d tensors under
    the JAX keys, with `depth_bins/min` and `depth_bins/max`."""
    if opt.compute_dtype not in _COMPUTE:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE)}")
    n = opt.grad_accum
    update_bins = not opt.freeze_teacher_and_pose and not opt.notadabins
    loss_fn = make_loss_fn(model, opt)

    def train_step(state: TrainState, batch,
                   draws: Union[StepDraws, Sequence[StepDraws], None] = None):
        with span("train.step"):
            return _step(state, batch, draws)

    def _step(state, batch, draws):
        micro = split_microbatches(batch_to_device(batch, state.device), n)
        if draws is None:
            B = micro[0][("color", 0, 0)].shape[0] * dist.world()
            draws = [draw(state.generator, B, opt.height, opt.width)
                     for _ in micro]
        elif isinstance(draws, StepDraws):
            draws = [draws]
        if len(draws) != n:
            raise ValueError(f"{len(draws)} StepDraws for {n} microbatches")
        draws = [rank_draws(d) for d in draws]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        per = []
        for inputs, dr in zip(micro, draws):
            total, metrics, mono_depth = loss_fn(
                inputs, state.min_depth_bin, state.max_depth_bin, dr)
            with span("train.backward"):
                total.backward()
            d = mono_depth.detach()
            per.append({"dmin": d.amin(dim=(1, 2, 3)).mean(),
                        "dmax": d.amax(dim=(1, 2, 3)).mean(),
                        **{k: v.detach() for k, v in metrics.items()}})
        metrics = per[0]
        with span("train.allreduce"):
            dist.average_gradients(model.parameters())
            if n > 1:
                with torch.no_grad():
                    for p in model.parameters():
                        if p.grad is not None:
                            p.grad.div_(n)
                metrics = {k: torch.stack([m[k] for m in per]).mean()
                           for k in metrics}
            if dist.enabled():
                names = list(metrics)
                mean = dist.all_reduce_mean(torch.stack([metrics[k] for k in names]))
                metrics = dict(zip(names, mean.unbind()))
        with span("train.optimizer"):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()

        dmin, dmax = metrics.pop("dmin"), metrics.pop("dmax")
        new_min, new_max = state.min_depth_bin, state.max_depth_bin
        if update_bins:
            with span("train.bins"):
                dmin = torch.clamp(dmin * 0.9, min=opt.min_depth)
                new_min = state.min_depth_bin * 0.99 + dmin * 0.01
                new_max = state.max_depth_bin * 0.99 + dmax * 1.1 * 0.01
        metrics["depth_bins/min"] = new_min
        metrics["depth_bins/max"] = new_max
        return TrainState(step=state.step + 1, min_depth_bin=new_min,
                          max_depth_bin=new_max,
                          generator=state.generator), metrics

    return train_step
