"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs and weights come from numpy seeds and pass between JAX and torch as
numpy arrays. `perturb` randomises what initialisation leaves at zero or
identity (adapter `D_fc2`, BN statistics) so folding and adapter bugs
cannot hide, as tests/test_ffn_mxu.py:27-46 does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppeadepth_tpu.models import RepDepth
from ppeadepth_tpu.options import Config

# the tiny teacher the port's parity tests share
TINY = Config(adapter=True, rep_size="t", height=64, width=96)


def perturb(tree, rng, path=()):
    """Copy of a flax variable tree as numpy, with BN statistics and
    adapter D_fc2 kernels redrawn from `rng`."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = perturb(v, rng, p)
        elif k == "mean":
            out[k] = rng.randn(*v.shape).astype(np.float32) * 0.05
        elif k == "var":
            out[k] = rng.rand(*v.shape).astype(np.float32) * 0.4 + 0.8
        elif "D_fc2" in p and k == "kernel":
            out[k] = rng.randn(*v.shape).astype(np.float32) * 0.05
        else:
            out[k] = np.asarray(v)
    return out


def jax_teacher(opt=TINY, seed=0):
    """Perturbed (params, batch_stats) of the JAX RepDepth teacher
    (mono_encoder + mono_depth only), training form."""
    model = RepDepth(opt)
    x = jnp.zeros((1, opt.height, opt.width, 3), jnp.float32)
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(seed),
         "droppath": jax.random.PRNGKey(seed + 1)},
        x, False, method=RepDepth.forward_mono))()
    rng = np.random.RandomState(seed)
    return (perturb(jax.device_get(variables["params"]), rng),
            perturb(jax.device_get(variables["batch_stats"]), rng))


def nhwc_to_torch(a):
    """numpy NHWC -> torch NCHW view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def torch_to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def strip(sd, prefix):
    """Sub-state_dict under `prefix.` with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
