"""Data parallelism across processes, one process per device (JAX
counterpart: parallel/mesh.py, whose dp mesh shards the batch and
replicates the state, with GSPMD adding the collectives).

Launch: `PPEA_DISTRIBUTED=1 torchrun --nproc_per_node N -m
ppeadepth_tpu_torch.train ...` (torchrun sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; `init_from_env` reads them).
NCCL joins the cards, gloo the CPU processes of the tests. On the cards
`PPEA_DIST_BACKEND=gloo` asks for gloo instead (as the JAX package's own
multi-process test takes gloo's CPU collectives): gloo lets several ranks
share a card, which NCCL refuses, so a one-card machine can run two
ranks; the collectives then stage the card's tensors through the host.
The card rule: rank LOCAL_RANK takes card LOCAL_RANK under NCCL (one card
a rank), and card LOCAL_RANK % device_count() under gloo. There is no
`nn.DataParallel` and no DDP wrapper: the training step averages the
gradients itself (`average_gradients`), after the backward of every
microbatch, as the JAX step's psum does.

What the JAX mesh gives and the port does by hand:
  * `--batch_size` is the global batch, as in JAX (trainer.py:70-73);
    each rank takes rows [rank * B/W, (rank + 1) * B/W) of it (the
    loaders' `rank_share`, `rank_rows`);
  * every per-sample random draw is made for the global batch from a
    generator in the same state on every rank, and sliced the same way,
    so W ranks see the inputs one process sees;
  * BatchNorm's train-mode statistics are the global batch's
    (`GlobalBatchNorm`, swapped in by `convert_global_bn`);
  * losses are per-rank contributions whose mean over ranks is the
    global-batch value; metrics and gradients are averaged over ranks.

With no process group every helper is the identity and the port runs as
one process. `collective_counts` counts the collectives this module
issues (the card's smoke run reads it to show that they ran).
"""

from __future__ import annotations

import collections
import os
from typing import Iterable

import torch
import torch.distributed as dist
import torch.nn as nn

collective_counts: "collections.Counter[str]" = collections.Counter()


def requested() -> bool:
    """Whether the environment asks for data parallelism:
    PPEA_DISTRIBUTED=1, or torchrun's WORLD_SIZE above 1."""
    return (os.environ.get("PPEA_DISTRIBUTED") == "1"
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def backend_for(device_type: str, environ=os.environ) -> str:
    """The process group's backend: NCCL on the cards unless
    PPEA_DIST_BACKEND=gloo, gloo on the CPU. An NCCL group that fails is
    an error, never retried as gloo."""
    asked = environ.get("PPEA_DIST_BACKEND", "")
    if asked not in ("", "nccl", "gloo"):
        raise ValueError(f"PPEA_DIST_BACKEND={asked!r}: nccl or gloo")
    if device_type != "cuda":
        if asked == "nccl":
            raise ValueError("PPEA_DIST_BACKEND=nccl needs the cards; the "
                             "CPU's processes take gloo")
        return "gloo"
    return asked or "nccl"


def card_for(local: int, n_cards: int, backend: str) -> int:
    """The card of the rank with LOCAL_RANK `local` on a machine of
    `n_cards`: its own under NCCL, shared round robin under gloo."""
    if n_cards < 1:
        raise RuntimeError("no CUDA card for a rank on the cards")
    if backend == "gloo":
        return local % n_cards
    if local >= n_cards:
        raise RuntimeError(f"LOCAL_RANK {local} under NCCL needs a card of "
                           f"its own and the machine has {n_cards}; "
                           f"PPEA_DIST_BACKEND=gloo lets ranks share one")
    return local


def init_from_env(device_type: str = "cuda") -> bool:
    """Join the process group that torchrun's variables describe (env://)
    when `requested()`, over `backend_for(device_type)`; on the cards
    first make `card_for` this rank's current card, the one that
    `train.trainer.resolve_device("cuda")` then gives it. Returns whether
    a group is up."""
    if not requested():
        return False
    if not dist.is_initialized():
        backend = backend_for(device_type)
        if device_type == "cuda":
            torch.cuda.set_device(card_for(
                local_rank(), torch.cuda.device_count(), backend))
        dist.init_process_group(backend)
    return True


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if enabled():
        dist.destroy_process_group()


def enabled() -> bool:
    """Whether a process group is up (world size 1 included)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if enabled() else 1


def rank() -> int:
    return dist.get_rank() if enabled() else 0


def is_main() -> bool:
    """Rank 0, which alone writes checkpoints and logs."""
    return rank() == 0


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """`t` where the group's backend reduces it: on the card under NCCL,
    on the CPU under gloo."""
    want = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return t if t.device.type == want else t.to(want)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the ranks, in place; `t` as it is without a
    group."""
    if enabled():
        buf = _on_backend(t)
        dist.all_reduce(buf)
        collective_counts["all_reduce"] += 1
        if buf is not t:
            t.copy_(buf)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean of `t` over the ranks (a new tensor)."""
    if not enabled():
        return t
    return all_reduce_sum_(t.detach().clone()) / world()


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """`.grad` of every parameter that has one replaced by its mean over
    the ranks: one all-reduce of the gradients packed flat."""
    if not enabled():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum_(flat)
    flat /= world()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def replicate(module: nn.Module) -> None:
    """Every parameter and buffer of `module` broadcast from rank 0."""
    if not enabled():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            buf = _on_backend(t.data)
            dist.broadcast(buf, 0)
            collective_counts["broadcast"] += 1
            if buf is not t.data:
                t.data.copy_(buf)


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of `t`, whose first axis is the global batch (or a
    global microbatch): rows [rank * n, (rank + 1) * n), n = len / W."""
    W = world()
    if W == 1:
        return t
    if t.shape[0] % W:
        raise ValueError(f"a batch of {t.shape[0]} does not split over "
                         f"{W} ranks")
    n = t.shape[0] // W
    r = rank()
    return t[r * n:(r + 1) * n]


class _GlobalBN(torch.autograd.Function):
    """Train-mode batch norm over the global batch: the per-channel sum
    and count, then the sum of squared deviations from the global mean,
    each all-reduced (two passes, so the variance keeps f32 accuracy);
    the backward all-reduces its two per-channel gradient sums. Statistics
    in f32; the output in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[1]
        xf = x.float()
        s = torch.cat([xf.sum((0, 2, 3)),
                       xf.new_tensor([x.numel() // C])])
        all_reduce_sum_(s)
        n = s[C]
        mean = s[:C] / n
        xc = xf - mean[None, :, None, None]
        var = all_reduce_sum_((xc * xc).sum((0, 2, 3))) / n
        invstd = torch.rsqrt(var + eps)
        y = (xc * invstd[None, :, None, None] * weight[None, :, None, None]
             + bias[None, :, None, None])
        ctx.save_for_backward(x, mean, invstd, weight, n)
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, gy, *_):
        x, mean, invstd, weight, n = ctx.saved_tensors
        C = x.shape[1]
        xhat = (x.float() - mean[None, :, None, None]) * invstd[None, :, None, None]
        g = gy.float()
        local = torch.cat([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])
        total = all_reduce_sum_(local.clone())
        sum_g, sum_gx = total[:C, None, None], total[C:, None, None]
        dx = (weight * invstd)[:, None, None] * (g - sum_g / n
                                                 - xhat * (sum_gx / n))
        return dx.to(x.dtype), local[C:], local[:C], None


class GlobalBatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode statistics are those of the global
    batch over every rank: the normalisation uses its biased variance, the
    running variance the unbiased one over the global count (torch's
    semantics, which JAX `models/norm.BatchNorm` reproduces). With no
    process group, and in eval mode, it is `nn.BatchNorm2d`.
    (`nn.SyncBatchNorm` takes CUDA tensors only, so the CPU tests could
    not hold it against JAX.)"""

    def forward(self, x):
        if not (self.training and enabled()):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        m = self.momentum
        y, mean, var, n = _GlobalBN.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
        return y


def convert_global_bn(module: nn.Module) -> nn.Module:
    """Every `nn.BatchNorm2d` of `module` made a `GlobalBatchNorm` in place
    (its parameters and buffers kept, so an optimizer built before still
    holds them); returns `module`."""
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm
    return module
