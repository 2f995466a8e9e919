"""Training orchestrator (JAX counterpart: train/trainer.py; the reference's
Trainer, trainer.py:83-418): datasets and loaders, the model and its
optimizer, checkpoints, and the loop of training steps with validation.

Stage 2 is `--train_cs --dc --ktf --load_weights_folder <stage 1>`: the
CityScapes preset, the decoder adapters with their freezing, and a warm
start that takes the stage-1 weights, BN statistics and depth bins and
starts at step 0 with a fresh Adam.

`--grad_accum N` splits each batch into N microbatches inside the step
(train/step.py); a step is still one full batch, so `steps_per_epoch`
and the schedule count full batches, as in JAX. `--fast_pipeline
[--decode_cache DIR]` feeds the step from `data.fast_pipeline`: native
decode on the host, then the upload and the augmentation on the device,
with draws from a device generator of their own.

Data parallelism (`parallel.dist`, a process group set up before the
Trainer, one process a card): `--batch_size` is the global batch, as in
JAX; each rank loads its share of the same shuffled global batches, every
BatchNorm becomes a `GlobalBatchNorm`, the weights are broadcast from rank
0, validation is split over the ranks with its error sums all-reduced,
and only rank 0 prints, logs and writes checkpoints.

Differences from the JAX Trainer: one process a device instead of one
mesh; the JAX package's automatic `--remat_loss` guard for a 16 GB TPU
has no counterpart; a plain resume (no `--ktf`) takes the step count from the
checkpoint's track.json, where the JAX Trainer keeps its fresh step.
Logging is stdout and `metrics.jsonl` under the JAX keys; the stdout line
every `LOG_EVERY` steps gives images a second and the share of that wall
time spent blocked on the next batch (`loader_wait_s`).
"""

from __future__ import annotations

import json
import os
import time

import torch

from .. import data as D
from ..ckpt import io as ckpt_io
from ..eval import evaluator, metrics as M
from ..models import RepDepth, init_weights
from ..models.repdepth import cudnn_without_tf32
from ..parallel import dist
from ..utils.trace import span
from . import freeze, schedule
from .step import create_train_state, make_train_step

# training steps between two metrics records (trainer.py: every 50)
LOG_EVERY = 50


def readlines(path):
    with open(path) as f:
        return [line.rstrip() for line in f if line.rstrip()]


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (the CLI runs
    on the card and does not fall back to the CPU). A bare "cuda" is the
    current card: a data-parallel rank's, which `parallel.dist.init_from_env`
    set by its card rule (`card_for`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and none is "
                           "available; pass device='cpu' to run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _print(*args):
    """print on rank 0 only."""
    if dist.is_main():
        print(*args)


class Trainer:
    """opt: `options.Config` (or the JAX package's); splits_dir: holds
    <split>/{train,test}_files.txt and the GT depths of <eval_split>
    (`evaluator.load_gt_depths`); device: "cuda" unless the caller asks for
    the CPU. The validation set is the training dataset's test split, or,
    for any dataset other than KITTI, the `cityscapes_eval` layout under
    `opt.cs_eval_path` (trainer.py:110-116). Under a process group
    (`parallel.dist`) the Trainer is one rank of a data-parallel run."""

    def __init__(self, opt, splits_dir: str = "./splits", device="cuda"):
        self.opt = opt = opt.with_mode_presets()
        self.device = device = resolve_device(device)
        self.splits_dir = splits_dir
        self.log_path = os.path.join(opt.log_dir, opt.name)
        os.makedirs(self.log_path, exist_ok=True)
        W = dist.world()
        if opt.batch_size % (W * opt.grad_accum):
            raise ValueError(
                f"--batch_size {opt.batch_size} (the global batch) must be a "
                f"multiple of {W} ranks x --grad_accum {opt.grad_accum}")
        shard = dict(rank=dist.rank(), world=W)

        # datasets
        frames_to_load = list(opt.frame_ids)
        for idx in opt.matching_ids:
            if idx not in frames_to_load:
                frames_to_load.append(idx)
        self.train_loader = self.val_loader = None
        if opt.data_path:
            ds_cls = D.DATASETS[opt.dataset]
            fpath = os.path.join(splits_dir, opt.split, "{}_files.txt")
            img_ext = ".png" if opt.png else ".jpg"
            train_ds = ds_cls(
                opt.data_path, readlines(fpath.format("train")), opt.height,
                opt.width, frames_to_load, 4, is_train=True, img_ext=img_ext)
            val_cls, val_path = ds_cls, opt.data_path
            if opt.dataset != "kitti":
                val_cls = D.DATASETS["cityscapes_eval"]
                val_path = opt.cs_eval_path
            val_ds = val_cls(
                val_path, readlines(fpath.format("test")), opt.height,
                opt.width, [0, -1], 4, is_train=False, img_ext=img_ext)
            if opt.fast_pipeline:
                from ..data.fast_pipeline import FastDecodePipeline

                self.train_loader = FastDecodePipeline(
                    train_ds, opt.batch_size, sorted(set(frames_to_load)),
                    shuffle=True, n_threads=opt.num_workers,
                    cache_dir=opt.decode_cache, **shard)
            else:
                self.train_loader = D.DataLoader(
                    train_ds, opt.batch_size, shuffle=True,
                    num_workers=opt.num_workers, **shard)
            self.val_loader = D.DataLoader(
                val_ds, opt.batch_size, shuffle=False,
                num_workers=opt.num_workers, drop_last=False, **shard)
            self.steps_per_epoch = len(self.train_loader)
        else:
            self.steps_per_epoch = 1000  # synthetic / smoke mode

        # model and state: random init, then the ImageNet bootstrap of a
        # from-scratch run (a checkpoint to resume from supersedes it)
        self.model = RepDepth(opt)
        init_weights(self.model, torch.Generator().manual_seed(0))
        if opt.weights_init == "pretrained" and not opt.load_weights_folder:
            from ..ckpt.pretrained import bootstrap_pretrained

            bootstrap_pretrained(self.model, opt)
        seed = opt.pytorch_random_seed or 0
        self.state = create_train_state(
            self.model, opt, device=device,
            generator=torch.Generator(device).manual_seed(seed))
        # the fast pipeline's augmentation draws
        self.aug_generator = torch.Generator(device).manual_seed(seed + 1)
        if dist.enabled():
            dist.convert_global_bn(self.model)
            dist.replicate(self.model)
        labels = freeze.param_labels(self.model, opt)
        if dist.is_main():
            freeze.print_num_param(self.model, labels)
        lr = 1e-6 if opt.freeze_pose else opt.learning_rate
        self.optimizer, self.scheduler = schedule.make_optimizer(
            [p for p in self.model.parameters() if p.requires_grad], lr,
            self.steps_per_epoch, opt.scheduler_step_size)
        if opt.load_weights_folder:
            self.load_model(opt.load_weights_folder)
        self.step_fn = make_train_step(self.model, opt, self.optimizer,
                                       self.scheduler)
        # seconds blocked on the next training batch, over the Trainer's life
        self.loader_wait_s = 0.0
        self._metrics_file = None
        if dist.is_main():
            self._metrics_file = open(
                os.path.join(self.log_path, "metrics.jsonl"), "a")

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
        if hasattr(self.train_loader, "close"):
            self.train_loader.close()

    # ------------------------------------------------------------------ #

    def load_model(self, folder: str):
        """Resume from a checkpoint folder: weights and BN statistics, the
        depth bins, and Adam with its schedule and the step count. Under
        --ktf (a warm start into a new run, as stage 2 from a stage-1
        model, trainer.py:151) only the weights, BN statistics and depth
        bins: the step stays 0 and Adam fresh, as in the JAX Trainer."""
        track = ckpt_io.load_model(folder, self.model)
        if not self.opt.ktf:
            ckpt_io.load_adam(folder, self.optimizer, self.scheduler)
        dev = self.state.device
        self.state.min_depth_bin = torch.tensor(
            track.get("min_depth_bin", 0.1), dtype=torch.float32, device=dev)
        self.state.max_depth_bin = torch.tensor(
            track.get("max_depth_bin", 10.0), dtype=torch.float32, device=dev)
        if not self.opt.ktf:
            self.state.step = int(track.get("step", 0))
        _print(f"loaded checkpoint from {folder} "
               f"(bins {self.state.min_depth_bin.item():.3f}"
               f"/{self.state.max_depth_bin.item():.3f})")

    def save_model(self, suffix: str):
        """Write the checkpoint folder (rank 0 only); returns its path, or
        None on another rank."""
        if not dist.is_main():
            return None
        folder = os.path.join(self.log_path, f"{self.opt.name}_{suffix}")
        ckpt_io.save_checkpoint(folder, self.model, self.optimizer,
                                self.scheduler, self.state, self.opt)
        print(f"saved checkpoint to {folder}")
        return folder

    def log_metrics(self, step: int, metrics: dict, prefix: str = "train"):
        if self._metrics_file is None:
            return
        rec = {"step": step, "prefix": prefix}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()

    # ------------------------------------------------------------------ #

    def train(self):
        opt = self.opt
        if self.train_loader is None:
            raise ValueError("--data_path required to train")
        step = self.state.step
        t_last, wait_last = time.perf_counter(), self.loader_wait_s
        start_epoch = step // max(self.steps_per_epoch, 1)
        for epoch in range(start_epoch, opt.num_epochs):
            self.train_loader.set_epoch(epoch)
            for batch in self._waited(self._batches()):
                self.state, metrics = self.step_fn(self.state, batch)
                step = self.state.step
                if step == 250 and opt.validate_every > 0:
                    # early validation snapshot (trainer.py:366-381)
                    self.validate(step)
                if step % LOG_EVERY == 0:
                    metrics = {k: v.item() for k, v in metrics.items()}
                    dt = time.perf_counter() - t_last
                    ips = LOG_EVERY * opt.batch_size / dt
                    wait = 100.0 * (self.loader_wait_s - wait_last) / dt
                    t_last, wait_last = time.perf_counter(), self.loader_wait_s
                    _print(f"epoch {epoch} step {step} "
                           f"loss {metrics['loss']:.4f} {ips:.1f} img/s, "
                           f"loader wait {wait:.1f} %")
                    self.log_metrics(step, metrics)
                if opt.validate_every > 0 and step % opt.validate_every == 0:
                    self.validate(step)
                    self.save_model(f"s{step}")
        self.save_model("final")

    def _waited(self, batches):
        """`batches`, each wait for the next one a `train.loader_wait` span
        whose seconds add to `loader_wait_s`."""
        end = object()
        while True:
            t = time.perf_counter()
            with span("train.loader_wait"):
                batch = next(batches, end)
            self.loader_wait_s += time.perf_counter() - t
            if batch is end:
                return
            yield batch

    def _batches(self):
        """The epoch's training batches on the device: the fast pipeline's
        decoded frames through `prepare_batch` (color_scales=1: the step
        reads the colours of scale 0 only), or the loader's through
        `device_prefetch`."""
        opt = self.opt
        if not opt.fast_pipeline:
            yield from D.device_prefetch(iter(self.train_loader), self.device)
            return
        from ..data.fast_pipeline import prepare_batch

        for frames, K in self.train_loader:
            yield prepare_batch(frames, K, self.aug_generator, opt.height,
                                opt.width, 4, 1, self.device)

    def validate(self, step: int):
        if self.val_loader is None:
            return None
        # this rank's share of the set (all of it without a process group)
        indices = [int(i) for b in self.val_loader.batch_indices() for i in b]
        with cudnn_without_tf32():  # as evaluate_depth.evaluate
            errors, mono_errors = evaluator.run_eval(
                self.model, self.opt, iter(self.val_loader),
                min_bin=self.state.min_depth_bin,
                max_bin=self.state.max_depth_bin,
                with_teacher=not self.opt.freeze_teacher_and_pose,
                splits_dir=self.splits_dir, device=self.device,
                indices=indices)
        _print(f"[val @ {step}]\n" + M.format_metrics(errors))
        self.log_metrics(step, dict(zip(M.METRIC_NAMES, errors)), prefix="val")
        if mono_errors is not None:
            _print("[val mono]\n" + M.format_metrics(mono_errors))
            self.log_metrics(step, dict(zip(M.METRIC_NAMES, mono_errors)),
                             prefix="val_mono")
        return errors
