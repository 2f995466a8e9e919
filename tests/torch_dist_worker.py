"""Worker of tests/test_torch_dp.py: one rank of the port's data-parallel
runs over gloo on the CPU, or, called in-process with no process group,
the one-process reference of the same runs.

    python tests/torch_dist_worker.py <port> <world> <rank> <indir> <outdir>

Reads from <indir>: `state.pt` (a RepDepth state_dict), `inputs.pkl` (the
global batches and draws) and the synthetic KITTI set under `data/`.
Writes <outdir>/rank<r>.pkl: a dict of numpy arrays and floats from
  * `global_bn`: a GlobalBatchNorm over this rank's rows of a seeded
    global batch: output, input and parameter gradients, running stats;
  * `step_<name>`: one training step of this rank's rows of a global batch
    (A: the JAX parity setup, draws handed in; B: drop path and matching
    augmentation drawn from the state's generator; accum: --grad_accum 2):
    metrics, gradients, updated parameters and BN buffers;
  * `trainer`: the Trainer on the KITTI set, 2 steps of global batch 2
    and a validation from the step runs' weights: each step's loss, the
    validation errors, the checkpoint folders this rank wrote (None where
    it wrote none) and whether it opened metrics.jsonl.
Imports the port only (no JAX)."""

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppeadepth_tpu_torch.models import RepDepth  # noqa: E402
from ppeadepth_tpu_torch.options import Config  # noqa: E402
from ppeadepth_tpu_torch.parallel import dist  # noqa: E402
from ppeadepth_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from ppeadepth_tpu_torch.train.step import (  # noqa: E402
    StepDraws, create_train_state, make_train_step)

# the JAX parity setup of tests/test_torch_train_step.py (its OPT)
OPT_A = Config(adapter=True, rep_size="t", height=64, width=96,
               drop_path_rate=0.0, no_matching_augmentation=True)
OPTS = {"A": OPT_A,
        "B": OPT_A.replace(drop_path_rate=0.3, no_matching_augmentation=False),
        "accum": OPT_A.replace(grad_accum=2)}
BN_SHAPE = (4, 6, 5, 7)


def bn_inputs():
    """(x, the loss's weights, BN weight, BN bias) of the global BN check."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(BN_SHAPE, generator=g) * 2 + 3
    w = torch.randn(BN_SHAPE, generator=g)
    return (x, w, 1 + 0.1 * torch.randn(6, generator=g),
            0.1 * torch.randn(6, generator=g))


def global_bn():
    x, w, weight, bias = bn_inputs()
    bn = dist.GlobalBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xr = dist.rank_rows(x).clone().requires_grad_()
    y = bn(xr)
    (y * dist.rank_rows(w)).sum().backward()
    return dict(y=y.detach().numpy(), dx=xr.grad.numpy(),
                dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy(),
                count=int(bn.num_batches_tracked))


def step(name, state_dict, batch, draws):
    opt = OPTS[name]
    model = RepDepth(opt)
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model, opt, device="cpu",
                               generator=torch.Generator().manual_seed(5))
    if dist.enabled():
        dist.convert_global_bn(model)
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], 1e-4, 100)
    train_step = make_train_step(model, opt, optim, sched)
    local = {k: dist.rank_rows(torch.as_tensor(v)) for k, v in batch.items()}
    if draws is not None:
        draws = StepDraws(**{k: torch.as_tensor(v) for k, v in draws.items()})
    state, metrics = train_step(state, local, draws)
    return dict(
        metrics={k: v.item() for k, v in metrics.items()},
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()
               if p.grad is not None},
        params={n: p.detach().numpy().copy()
                for n, p in model.named_parameters() if p.requires_grad},
        buffers={n: b.numpy().copy() for n, b in model.named_buffers()
                 if "running" in n})


def trainer(indir, outdir, state_dict):
    from ppeadepth_tpu_torch.train.trainer import Trainer

    opt = Config(adapter=True, rep_size="t", height=64, width=96,
                 data_path=os.path.join(indir, "data", "kitti"), split="tiny",
                 eval_split="tiny", batch_size=2, num_epochs=1, num_workers=1,
                 validate_every=2, weights_init="scratch", name="dp",
                 log_dir=os.path.join(outdir, "logs"))
    t = Trainer(opt, splits_dir=os.path.join(indir, "data", "splits"),
                device="cpu")
    # the drawn weights of the step runs in place of the scratch init,
    # whose near-uniform disparities tie the automask at many pixels
    t.model.load_state_dict(state_dict, strict=True)
    losses, errors, saved = [], [], []
    step_fn, validate, save_model = t.step_fn, t.validate, t.save_model

    def recorded_step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
        return state, metrics

    def recorded_validate(s):
        e = validate(s)
        errors.append(np.asarray(e))
        return e

    def recorded_save(suffix):
        folder = save_model(suffix)
        saved.append(None if folder is None else os.path.basename(folder))
        return folder

    t.step_fn, t.validate, t.save_model = (recorded_step, recorded_validate,
                                           recorded_save)
    try:
        t.train()
    finally:
        t.close()
    return dict(losses=losses, errors=errors, saved=saved,
                metrics_file=t._metrics_file is not None,
                final={k: v.numpy() for k, v in t.model.state_dict().items()})


def run_all(indir, outdir):
    """Every run of this rank (or of the one process); the result dict is
    also written to <outdir>/rank<r>.pkl."""
    torch.set_num_threads(1)
    state_dict = torch.load(os.path.join(indir, "state.pt"))
    with open(os.path.join(indir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {"global_bn": global_bn()}
    for name in OPTS:
        batch, draws = inputs[name]
        out["step_" + name] = step(name, state_dict, batch, draws)
    out["trainer"] = trainer(indir, outdir, state_dict)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"rank{dist.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return out


def main():
    port, world, rank, indir, outdir = sys.argv[1:6]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=int(world),
        rank=int(rank))
    try:
        run_all(indir, outdir)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
