"""Port serving path: `InferenceSession.predict_depth` against the JAX
deploy forward (the body of ppeadepth_tpu/serve.py:109-126) on the same
merged weights of the whole RepDepth, the port's freedom from jax, and
chip_smoke.py refusing to run without a card."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.ckpt.deploy import structural_reparam as jax_reparam
from ppeadepth_tpu.core.geometry import disp_to_depth
from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.serve import InferenceSession
from tests.torch_parity import TINY, compile_reference, jax_repdepth
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _disp(depth):
    lo, hi = 1.0 / TINY.max_depth, 1.0 / TINY.min_depth
    return (1.0 / depth - lo) / (hi - lo)


def test_predict_depth_matches_jax():
    """f32, B=2, 64x96, float and uint8 input. Compared as disparity
    (depth = 1/scaled disparity magnifies errors near max_depth): atol
    2e-4 as the module parity tests."""
    params, stats = jax_repdepth()
    mp, ms = jax_reparam(params, stats)
    model = JRepDepth(TINY.replace(merged=True))

    def predict(v, img):
        out = model.apply(v, img, False, method=JRepDepth.forward_mono)
        return disp_to_depth(out[("disp", 0)][..., 0], TINY.min_depth,
                             TINY.max_depth)[1]

    v = {"params": mp, "batch_stats": ms}
    x = jnp.zeros((2, TINY.height, TINY.width, 3), jnp.float32)
    compiled = compile_reference(predict, v, x)

    def jax_predict(img):
        return compiled(v, img)

    sd = state_dict_from_jax(params, stats)
    sess = InferenceSession(TINY, sd, device="cpu", dtype="float32")
    rng = np.random.RandomState(5)
    imgs = rng.rand(2, TINY.height, TINY.width, 3).astype(np.float32)
    u8 = (imgs * 255).astype(np.uint8)
    for inp, ref_in in ((imgs, imgs), (u8, u8.astype(np.float32) / 255.0)):
        depth = sess.predict_depth(inp)
        ref = np.asarray(jax_predict(jnp.asarray(ref_in)))
        assert depth.shape == (2, TINY.height, TINY.width)
        assert depth.dtype == np.float32
        assert np.isfinite(depth).all()
        np.testing.assert_allclose(_disp(depth), _disp(ref), rtol=0,
                                   atol=2e-4)
    # the training form (no reparam, ConvFFNs unfolded) serves the same
    unmerged = InferenceSession(TINY, sd, device="cpu", dtype="float32",
                                merge_reparam=False)
    np.testing.assert_allclose(_disp(unmerged.predict_depth(imgs)),
                               _disp(sess.predict_depth(imgs)), rtol=0,
                               atol=2e-4)


def test_session_bfloat16_cpu_close_to_float32():
    """The bf16 deploy form (plain versions on the CPU) tracks the f32 one
    on the tiny teacher: mean |d disp| 5e-3, the bound chip_smoke.py holds
    the card to."""
    g = torch.Generator().manual_seed(0)
    imgs = np.random.RandomState(6).rand(2, TINY.height, TINY.width, 3)
    s32 = InferenceSession(TINY, device="cpu", dtype="float32", generator=g)
    d32 = s32.predict_depth(imgs)
    # merged f32 keeps the unfolded ConvFFN (kernel B is bf16 only)
    assert s32.model.mono_encoder.stages[0].blocks[1].folded_w_up is None
    g = torch.Generator().manual_seed(0)
    sess = InferenceSession(TINY, device="cpu", dtype="bfloat16", generator=g)
    d16 = sess.predict_depth(imgs)
    ffn = sess.model.mono_encoder.stages[0].blocks[1]
    assert ffn.folded_w_up.dtype == torch.bfloat16
    assert ffn.folded_b_up.dtype == torch.float32
    assert sess.model.mono_depth.disp_convs[0].conv.weight.dtype == torch.float32
    assert np.abs(_disp(d16) - _disp(d32)).mean() < 5e-3


_NO_JAX = """
import importlib
import pkgutil
import sys
import numpy as np

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ppeadepth_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
sys.meta_path.insert(0, Block())
import ppeadepth_tpu_torch
for info in pkgutil.walk_packages(ppeadepth_tpu_torch.__path__, "ppeadepth_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
from ppeadepth_tpu_torch.serve import InferenceSession
from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.train.schedule import make_optimizer
from ppeadepth_tpu_torch.train.step import create_train_state, make_train_step
import torch

opt = chip_smoke.TRAIN_B.replace(rep_size="t", height=64, width=96,
                                 compute_dtype="float32")
d = InferenceSession(opt, device="cpu", dtype="float32").predict_depth(
    np.zeros((1, 64, 96, 3), np.float32))
assert d.shape == (1, 64, 96)
model = RepDepth(opt)
init_weights(model, torch.Generator().manual_seed(0))
state = create_train_state(model, opt, device="cpu")
step = make_train_step(model, opt, *make_optimizer(
    [p for p in model.parameters() if p.requires_grad], 1e-4, 10))
state, metrics = step(state, chip_smoke._train_batch(np.random.RandomState(0), 2, opt))
assert np.isfinite(metrics["loss"].item()) and state.step == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """A fresh interpreter that cannot import jax, flax, optax or the JAX
    package imports every module of the port and chip_smoke.py, serves on
    the CPU and takes a training step."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED []" in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    """On a host without a card chip_smoke.py exits non-zero and prints no
    result line; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "is_available() is False" in proc.stderr
