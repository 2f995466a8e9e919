"""The program under test, as the harness takes it: the port's modules,
its `options.Config` for a configuration file, and the seeds of one
run's parts."""

from __future__ import annotations

SEED_MASK = 2 ** 63 - 1


def sub_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one use, from the run's seed of any size."""
    return (seed * 1_000_003 + salt * 7_919) & SEED_MASK


def port() -> dict:
    import ppeadepth_tpu_torch  # noqa: F401
    from ppeadepth_tpu_torch import kernels, options, serve
    from ppeadepth_tpu_torch.models import RepDepth
    from ppeadepth_tpu_torch.train import schedule, step
    return dict(kernels=kernels, options=options, serve=serve,
                RepDepth=RepDepth, schedule=schedule, step=step)


def config(port, cfg):
    """The program's `options.Config` for the configuration file."""
    Config = port["options"].Config
    fields = set(Config.__dataclass_fields__)
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg["options"].items() if k in fields}
    return Config(**kw)
