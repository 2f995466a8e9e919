"""The port's legacy eval (`ppeadepth_tpu_torch.eval_depth_ori`) against
JAX `ppeadepth_tpu.eval_depth_ori` on a synthetic KITTI set
(`torch_parity.kitti_set`: 4 test items at 64x96, two batches of 2), from the same legacy-format checkpoint files: the student
(poses chained through the pose net, the bin range from encoder.pth),
`--eval_teacher`, `--zero_cost_volume` and `--static_camera`; then
`--save_pred_disps`, `--no_eval`, `--ext_disp_to_eval` and the benchmark
PNGs, exactly.

The JAX reference runs as the JAX package runs it, its eval step jitted:
one compile a mode, which on the CPU takes less time than running the
step eagerly (where every operation compiles on its first use).
"""

import os

import numpy as np
import pytest
import torch

from ppeadepth_tpu import eval_depth_ori as jax_eval
from ppeadepth_tpu.options import Config
from ppeadepth_tpu_torch import eval_depth_ori as port_eval
from ppeadepth_tpu_torch.models.pose import PoseDecoder
from ppeadepth_tpu_torch.models.resnet import ResnetEncoder
from ppeadepth_tpu_torch.models.resnet_matching import (
    DepthDecoder, ResnetEncoderMatching)
from tests.torch_parity import kitti_set
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

H, W, BINS = 64, 96, 8
# scaled disparities (0.01-10 at min/max depth 0.1/100): f32 summation
# order through the pose net, the encoder and the decoder
DISP_ATOL = 2e-4
MODES = {"multi": {}, "teacher": {"eval_teacher": True},
         "zero_cv": {"zero_cost_volume": True},
         "static_camera": {"static_camera": True}}


def draw_weights(module, gen):
    """Seeded weights in place: conv kernels N(0, 1/fan_in), BN scales
    1 + 0.1 N, biases and running means 0.05 N, running variances
    U(0.8, 1.2)."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not torch.is_floating_point(t):
                continue
            if name.endswith("running_var"):
                t.uniform_(0.8, 1.2, generator=gen)
            elif name.endswith(("running_mean", "bias")):
                t.normal_(0.0, 0.05, generator=gen)
            elif t.dim() == 1:
                t.normal_(1.0, 0.1, generator=gen)
            else:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=gen)


def write_legacy_checkpoint(folder, gen, num_depth_bins, bins=(0.15, 18.0)):
    """The reference's separate-file checkpoint (eval_depth_ori.py:
    119-190) of seeded legacy networks: encoder.pth (with the bin range,
    height and width beside the weights), depth.pth, pose_encoder.pth,
    pose.pth, mono_encoder.pth, mono_depth.pth."""
    os.makedirs(folder, exist_ok=True)
    enc = ResnetEncoderMatching(18, num_depth_bins, "log")
    pose_enc = ResnetEncoder(18, num_input_images=2)
    mono_enc = ResnetEncoder(18)
    nets = {"encoder": enc, "depth": DepthDecoder(),
            "pose_encoder": pose_enc,
            "pose": PoseDecoder(pose_enc.num_ch_enc, 2),
            "mono_encoder": mono_enc, "mono_depth": DepthDecoder()}
    for name, net in nets.items():
        draw_weights(net, gen)
        sd = dict(net.state_dict())
        if name == "encoder":
            sd.update(min_depth_bin=torch.tensor(bins[0]),
                      max_depth_bin=torch.tensor(bins[1]), height=H, width=W)
        torch.save(sd, os.path.join(folder, f"{name}.pth"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    data_path, splits_dir = kitti_set(root, 4, 4)
    ckpt = str(root / "ckpt")
    write_legacy_checkpoint(ckpt, torch.Generator().manual_seed(3), BINS)
    opt = Config(data_path=data_path, load_weights_folder=ckpt,
                 eval_split="tiny", height=H, width=W, batch_size=2,
                 num_workers=1, num_depth_bins=BINS)
    return opt, splits_dir


@pytest.fixture(scope="module")
def predictions(setup):
    """{mode: (port disparities, JAX disparities)} on the CPU."""
    opt, splits_dir = setup
    out = {}
    for mode, flags in MODES.items():
        o = opt.replace(**flags)
        got = port_eval.predict_disps(o, splits_dir, device="cpu")
        ref = jax_eval.predict_disps(o, splits_dir)
        out[mode] = (got, np.asarray(ref))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_disps_matches_jax(predictions, mode):
    got, ref = predictions[mode]
    assert got.shape == ref.shape == (4, H, W) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=DISP_ATOL)


def test_modes_differ(predictions):
    """Each flag reaches the path: the four modes give four answers."""
    disps = [p[0] for p in predictions.values()]
    for i in range(len(disps)):
        for j in range(i):
            assert np.abs(disps[i] - disps[j]).max() > 1e-3


def test_save_ext_no_eval_and_benchmark_exact(setup, predictions, tmp_path):
    """--save_pred_disps --no_eval writes the predictions and scores
    nothing; --ext_disp_to_eval scores them as JAX does, exactly; the
    benchmark split writes JAX's uint16 PNGs, byte for byte."""
    from PIL import Image

    opt, splits_dir = setup
    o = opt.replace(save_pred_disps=True, no_eval=True)
    assert port_eval.evaluate(o, splits_dir, device="cpu") is None
    saved = os.path.join(opt.load_weights_folder, "multi_tiny_split.npy")
    np.testing.assert_array_equal(np.load(saved), predictions["multi"][0])

    ext = opt.replace(ext_disp_to_eval=saved)
    got = port_eval.evaluate(ext, splits_dir, device="cpu")
    ref = jax_eval.evaluate(ext, splits_dir)
    assert len(got) == 7 and np.isfinite(got).all()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    disps = predictions["multi"][0]
    port_eval.save_benchmark_pngs(disps, str(tmp_path / "port"))
    jax_eval.save_benchmark_pngs(disps, str(tmp_path / "jax"))
    bench = ext.replace(eval_split="benchmark")
    assert port_eval.evaluate(bench, splits_dir, device="cpu") is None
    out_dir = os.path.join(opt.load_weights_folder, "benchmark_predictions")
    names = sorted(os.listdir(out_dir))
    assert names == [f"{i:010d}.png" for i in range(4)]
    for n in names:
        png = Image.open(os.path.join(out_dir, n))
        assert png.size == (1216, 352)
        a = np.asarray(png)
        assert a.dtype == np.uint16 and 0 < a.max() <= 80 * 256
        for d in ("port", "jax"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(str(tmp_path / d / n))), a)
