"""The port's pose nets against JAX in f32 at the tiny config (the
ResNet-18 pose encoder + PoseDecoder on a stacked pair), what a bf16
session keeps in f32, the pose net's own TF32 scope, and the student path's
freedom from jax. Split from tests/test_torch_student.py (the student
serving path against JAX), so that every port test file stays behind
tests/test_train_step.py in pytest-xdist's file queue.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ppeadepth_tpu.models.pose import PoseDecoder as JPoseDecoder
from ppeadepth_tpu.models.resnet import ResnetEncoder as JResnetEncoder
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.models.pose import PoseDecoder
from ppeadepth_tpu_torch.models.resnet import ResnetEncoder
from ppeadepth_tpu_torch.serve import InferenceSession
from tests.test_torch_student import ATOL, B, whole  # noqa: F401 (fixture)
from tests.torch_parity import (
    TINY, compile_reference, nhwc_to_torch, strip, torch_to_nhwc)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


ROOT = Path(__file__).resolve().parents[1]


def test_pose_nets_match_jax(whole):
    """ResnetEncoder(18, 2 images) pyramid and PoseDecoder output == JAX."""
    params, stats = whole
    sd = state_dict_from_jax(params, stats)
    x = np.random.RandomState(4).rand(B, TINY.height, TINY.width, 6).astype(
        np.float32)

    def nets(v, x):
        feats = JResnetEncoder(18, 2).apply(v["enc"], x, False)
        return feats, JPoseDecoder(JResnetEncoder(18, 2).num_ch_enc, 1, 2).apply(
            v["dec"], [feats])

    v = {"enc": {"params": params["pose_encoder"],
                 "batch_stats": stats["pose_encoder"]},
         "dec": {"params": params["pose"]}}
    jfeats, (jaa, jtt) = compile_reference(nets, v, x)(v, x)
    enc = ResnetEncoder(18, 2).eval()
    enc.load_state_dict(strip(sd, "pose_encoder"), strict=True)
    dec = PoseDecoder(enc.num_ch_enc, 2).eval()
    dec.load_state_dict(strip(sd, "pose"), strict=True)
    with torch.inference_mode():
        feats = enc(nhwc_to_torch(x))
        aa, tt = dec(feats)
    assert [f.shape[1] for f in feats] == list(enc.num_ch_enc)
    for f, r in zip(feats, jfeats):
        np.testing.assert_allclose(torch_to_nhwc(f), np.asarray(r), rtol=0,
                                   atol=ATOL)
    assert aa.shape == tt.shape == (B, 2, 1, 3)
    np.testing.assert_allclose(aa.numpy(), np.asarray(jaa), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jtt), rtol=0, atol=1e-5)


def test_bfloat16_session_keeps_pose_nets_float32():
    sess = InferenceSession(TINY, device="cpu", dtype="bfloat16")
    m = sess.model
    assert m.pose_encoder.encoder.conv1.weight.dtype == torch.float32
    assert m.pose.net[3].weight.dtype == torch.float32
    assert m.encoder.reduce_conv[0].weight.dtype == torch.bfloat16
    assert m.encoder.replk.stages[0].blocks[1].folded_w_up.dtype == torch.bfloat16
    assert m.depth.disp_convs[0].conv.weight.dtype == torch.float32


def test_pose_net_runs_without_tf32_in_scope():
    """The pose net turns cuDNN TF32 off for its own convs only (a user's
    process keeps torch's default around it)."""
    sess = InferenceSession(TINY, device="cpu", dtype="float32")
    seen = []
    sess.model.pose_encoder.register_forward_pre_hook(
        lambda m, args: seen.append(torch.backends.cudnn.allow_tf32))
    before = torch.backends.cudnn.allow_tf32
    img = np.zeros((1, TINY.height, TINY.width, 3), np.float32)
    sess.predict_pose(img, img)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 == before


_NO_JAX = """
import sys
from types import SimpleNamespace
import numpy as np
from ppeadepth_tpu_torch.serve import InferenceSession
opt = SimpleNamespace(adapter=True, rep_size="t", adpt_test=4, ratio=0.25,
                      g_blk=1.0, g_ffn=1.0, trans=False, input=False,
                      mono_trans=False, mono_input=False, dc=False,
                      dyn_cv=False, num_depth_bins=96, depth_binning="log",
                      height=64, width=96, min_depth=0.1, max_depth=100.0)
s = InferenceSession(opt, device="cpu", dtype="float32")
img = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
K = np.eye(4, dtype=np.float32)[None]
K[0, 0, 0], K[0, 1, 1], K[0, 0, 2], K[0, 1, 2] = 13.92, 30.72, 12.0, 8.0
d = s.predict_depth_multi(img, np.roll(img, 2, axis=2), K, np.linalg.inv(K))
assert d.shape == (1, 64, 96)
assert s.predict_pose(img, img).shape == (1, 4, 4)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ppeadepth_tpu"))
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


def test_student_path_imports_no_jax():
    """A fresh interpreter serving the student on the CPU loads nothing of
    jax, flax or the JAX package."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED []" in proc.stdout
