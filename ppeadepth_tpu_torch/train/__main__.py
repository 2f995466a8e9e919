"""CLI launcher: `python -m ppeadepth_tpu_torch.train <flags>` (JAX
counterpart: ppeadepth_tpu/train/__main__.py), with the JAX package's and
the reference's flag names (README.md:40-56):

  stage 1:  --adapter --use_checkpoint --data_path P --num_epochs N ...
  eval:     --eval --load_weights_folder P [--lk_backend pallas]

It runs on one CUDA card and raises without one. Splits are read from
./splits, as in the JAX package. Data parallelism over N cards, one
process each (`parallel.dist`; `--batch_size` is the global batch):

  PPEA_DISTRIBUTED=1 torchrun --nproc_per_node N -m ppeadepth_tpu_torch.train ...

The process group (NCCL) is set up before the Trainer and taken down
after it. `--eval` runs in one process.
"""

from __future__ import annotations

import sys


def seed_all(seed):
    import random

    import numpy as np
    import torch

    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)


def main(argv=None):
    """Parse `argv` and train, or evaluate under --eval; returns the
    Trainer, or evaluate's (errors, teacher errors)."""
    from ..options import parse_args

    opt = parse_args(argv)
    seed_all(opt.pytorch_random_seed)
    if opt.eval:
        from ..evaluate_depth import evaluate

        return evaluate(opt)

    from ..parallel import dist
    from .trainer import Trainer

    grouped = dist.init_from_env("cuda")
    try:
        trainer = Trainer(opt)
        try:
            trainer.train()
        finally:
            trainer.close()
    finally:
        if grouped:
            dist.shutdown()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
