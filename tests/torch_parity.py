"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs and weights come from numpy seeds and pass between JAX and torch as
numpy arrays. `perturb` randomises what initialisation leaves at zero or
identity (adapter `D_fc2`, BN statistics) so folding and adapter bugs
cannot hide, as tests/test_ffn_mxu.py:27-46 does. `jax_repdepth` draws the
whole JAX RepDepth tree once per process; `compile_reference` compiles a
JAX reference function with XLA's cheaper backend settings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.models import RepDepth
from ppeadepth_tpu.options import Config
from ppeadepth_tpu.train.trainer import synthetic_batch

# the tiny teacher the port's parity tests share
TINY = Config(adapter=True, rep_size="t", height=64, width=96)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread in a module that imports this fixture:
    the tiny CPU nets gain nothing from more, and the suite's parallel
    workers would otherwise oversubscribe the cores with spinning threads
    while JAX compiles its references. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@functools.lru_cache(maxsize=None)
def jax_repdepth(opt=TINY, seed=0):
    """(params, batch_stats) of the whole JAX RepDepth (student, teacher and
    pose nets) as numpy: LeCun-normal kernels, and biases, BN scales and
    statistics, and adapter D_fc2 kernels drawn away from their zero or
    identity init so folding and adapter bugs cannot hide. Drawn over the
    shapes of the init (jax.eval_shape, no compile), once per process and
    (opt, seed); the arrays are read-only, as every caller shares them."""
    shapes = jax.eval_shape(lambda: RepDepth(opt).init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1),
         "aug": jax.random.PRNGKey(2)},
        synthetic_batch(opt, 1), 0.1, 10.0, False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            scale = (0.05 if any(p.key == "D_fc2" for p in path)
                     else np.prod(shape[:-1]) ** -0.5)
            a = rng.randn(*shape) * scale
        elif name == "scale":
            a = 1 + 0.1 * rng.randn(*shape)
        elif name in ("bias", "mean"):
            a = 0.05 * rng.randn(*shape)
        else:
            assert name == "var", name
            a = rng.rand(*shape) * 0.4 + 0.8
        a = a.astype(np.float32)
        a.setflags(write=False)
        return a

    def tree(t):
        return jax.tree_util.tree_map_with_path(draw, t)

    return tree(shapes["params"]), tree(shapes["batch_stats"])


def compile_reference(fn, *args):
    """`fn` jitted and compiled for `args` with XLA's backend optimisation
    level 0: a JAX reference compiles in about 30 % less time; the f32
    results differ from the default build's by rounding only."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def nhwc_to_torch(a):
    """numpy NHWC -> torch NCHW view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def torch_to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def strip(sd, prefix):
    """Sub-state_dict under `prefix.` with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
