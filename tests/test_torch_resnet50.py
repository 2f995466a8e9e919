"""The ResNet-50 encoder, PoseCNN and the legacy eval's ResNet-50 teacher
against JAX on the CPU, in f32 at 64x96:

  * `models.resnet.ResnetEncoder(50)` (Bottleneck blocks, widths 64, 256,
    512, 1024, 2048) against JAX `ResnetEncoder(num_layers=50)` in eval mode
    and in train mode (batch statistics, then the running statistics), on
    a JAX tree converted by `ckpt.convert.legacy_state_dict_from_jax(...,
    "resnet")` and loaded strictly;
  * `models.pose.PoseCNN` against JAX `PoseCNN` (the reference's `net.<i>`
    names);
  * `eval_depth_ori --eval_teacher --num_layers 50` end to end on a
    synthetic KITTI set (`torch_parity.kitti_set`) against JAX
    `eval_depth_ori`, from the same legacy-format files.

The ResNet-50 references are compiled (`torch_parity.compile_reference`)
and JAX `eval_depth_ori` jits its own step: on the CPU that takes less
time than running them eagerly, where every operation compiles on its
first use; PoseCNN's runs eagerly. atol 2e-4 on features and disparities
(f32 summation order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu import eval_depth_ori as jax_eval
from ppeadepth_tpu.models.pose import PoseCNN as JPoseCNN
from ppeadepth_tpu.models.resnet import ResnetEncoder as JResnetEncoder
from ppeadepth_tpu.options import Config
from ppeadepth_tpu_torch import eval_depth_ori as port_eval
from ppeadepth_tpu_torch.ckpt.convert import (
    legacy_state_dict_from_jax, state_dict_from_jax)
from ppeadepth_tpu_torch.models.pose import PoseCNN
from ppeadepth_tpu_torch.models.resnet import ResnetEncoder
from ppeadepth_tpu_torch.models.resnet_matching import DepthDecoder
from tests.test_torch_eval_ori import draw_weights
from tests.torch_parity import compile_reference, kitti_set, random_tree
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

H, W, B = 64, 96, 2
ATOL = 2e-4
# Train mode normalises each level by its batch statistics, layer 4 over
# 12 values a channel (2 x 3, B=2), and 53 such BNs amplify f32 rounding:
# against a float64 forward of the port, the port's f32 levels are off by
# up to 2.0e-4 of the level's largest value and JAX's by 4.3e-4 (the port
# against itself at 1 and 4 CPU threads: 1.7e-4). Bound: 1e-3 of the
# level's largest value.
TRAIN_REL = 1e-3


def _jax_tree(module, x, seed):
    """(params, batch_stats) of `module` drawn by `random_tree` over the
    shapes of its init."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(seed)
    return (random_tree(shapes["params"], rng),
            random_tree(shapes.get("batch_stats", {}), rng))


@pytest.fixture(scope="module")
def resnet50():
    x = np.random.RandomState(5).rand(B, H, W, 3).astype(np.float32)
    jm = JResnetEncoder(num_layers=50)
    params, stats = _jax_tree(jm, x, 1)
    return jm, params, stats, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet50_matches_jax(resnet50, train):
    """The 5-level pyramid (atol ATOL in eval mode, TRAIN_REL of each
    level's largest value in train mode); in train mode also every running
    statistic after the step (TRAIN_REL of the buffer's largest value;
    observed 7.7e-5 of it at layer 4)."""
    jm, params, stats, x = resnet50
    v = {"params": params, "batch_stats": stats}
    if train:
        ref, upd = compile_reference(
            lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]), v, x)(v, x)
    else:
        ref = compile_reference(lambda v, x: jm.apply(v, x, False), v, x)(v, x)
    model = ResnetEncoder(50)
    assert model.num_ch_enc == (64, 256, 512, 1024, 2048)
    model.load_state_dict(legacy_state_dict_from_jax(params, stats, "resnet"),
                          strict=True)
    model.train(train)
    with torch.no_grad():
        feats = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(feats) == 5
    for r, f in zip(ref, feats):
        r = np.asarray(r)
        atol = TRAIN_REL * np.abs(r).max() if train else ATOL
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), r, rtol=0,
                                   atol=atol)
    if train:
        buffers = {k: v for k, v in model.state_dict().items()}
        new = state_dict_from_jax({}, upd["batch_stats"])
        assert any(".conv3" in k for k in buffers) and len(new) > 100
        for k, v in new.items():
            v = v.numpy()
            np.testing.assert_allclose(buffers["encoder." + k].numpy(), v,
                                       rtol=0, atol=TRAIN_REL * np.abs(v).max(),
                                       err_msg=k)


def test_posecnn_matches_jax():
    """Axis-angle and translation of three stacked frames, the JAX tree
    loaded strictly under the reference's `net.<i>` / `pose_conv` names."""
    x = np.random.RandomState(6).rand(B, H, W, 9).astype(np.float32)
    jm = JPoseCNN(num_input_frames=3)
    params, _ = _jax_tree(jm, x, 2)
    with jax.disable_jit():
        ref = jm.apply({"params": params}, jnp.asarray(x))
    model = PoseCNN(3).eval()
    sd = state_dict_from_jax(params, {})
    assert "net.6.weight" in sd and "pose_conv.weight" in sd
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        assert g.shape == (B, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_eval_ori_teacher_resnet50_matches_jax(tmp_path):
    """`--eval_teacher --num_layers 50`: the port's predictions and errors
    from mono_encoder.pth / mono_depth.pth against JAX's, the port's run
    under `cudnn_without_tf32` (eval_depth_ori.predict_disps)."""
    data_path, splits_dir = kitti_set(tmp_path, 4, 4)
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt)
    gen = torch.Generator().manual_seed(4)
    enc = ResnetEncoder(50)
    nets = {"mono_encoder": enc, "mono_depth": DepthDecoder(enc.num_ch_enc)}
    for name, net in nets.items():
        draw_weights(net, gen)
        torch.save(net.state_dict(), str(ckpt / f"{name}.pth"))
    opt = Config(data_path=data_path, load_weights_folder=str(ckpt),
                 eval_split="tiny", height=H, width=W, batch_size=2,
                 num_workers=1, eval_teacher=True, num_layers=50)
    got = port_eval.predict_disps(opt, splits_dir, device="cpu")
    ref = np.asarray(jax_eval.predict_disps(opt, splits_dir))
    assert got.shape == ref.shape == (4, H, W) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    errors = port_eval.evaluate(opt, splits_dir, device="cpu")
    assert len(errors) == 7 and np.isfinite(errors).all()
