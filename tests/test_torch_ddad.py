"""The port's DDAD evaluation and GT export against the JAX package's: the
KITTI GT export (`export_gt_depth`) on synthetic calibration and velodyne
files, exactly; `DDADNpzDataset` items byte for byte on the synthetic tree
of tests/test_ddad_export.py; `evaluate_ddad.eval_config`; the metrics at
DDAD's 200 m clamp; the CLI on the CPU; and the missing-GT message naming
the port's export. No JAX compile."""

import dataclasses
import os

import numpy as np
import pytest

from ppeadepth_tpu.data.ddad import DDADNpzDataset as JDDAD
from ppeadepth_tpu.eval import metrics as JM
from ppeadepth_tpu.evaluate_ddad import eval_config as jax_eval_config
from ppeadepth_tpu.export_gt_depth import export_gt_depths as jax_export
from ppeadepth_tpu.options import Config as JConfig
from ppeadepth_tpu_torch import data as D
from ppeadepth_tpu_torch import evaluate_ddad, export_gt_depth
from ppeadepth_tpu_torch.eval import evaluator as E
from ppeadepth_tpu_torch.eval import metrics as M
from ppeadepth_tpu_torch.options import Config, parse_args
from tests.test_ddad_export import _synthetic_tree
from tests.test_kitti_utils import _write_calib, _write_velo
from tests.torch_parity import TINY
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

SCENE = "2011_09_26"
FOLDER = f"{SCENE}/2011_09_26_drive_0001_sync"


def _kitti_scans(root, frames, rng):
    """Calibration of one scene and a random velodyne scan (points ahead
    of the car, some behind, some out of view) per frame under `root`."""
    _write_calib(str(root / SCENE), W=320, H=96, fx=150.0, fy=150.0)
    for f in frames:
        n = 4000
        pts = np.stack([rng.rand(n) * 70 - 5, rng.randn(n) * 8,
                        rng.randn(n) * 1.5], 1)
        _write_velo(str(root / FOLDER / f"velodyne_points/data/{f:010d}.bin"),
                    pts)


def test_export_matches_jax(tmp_path):
    """`python -m ppeadepth_tpu_torch.export_gt_depth` writes the JAX
    export's gt_depths.npz: the same object array under "data", equal
    depth maps."""
    frames = [3, 4, 9]
    _kitti_scans(tmp_path / "kitti", frames, np.random.RandomState(0))
    for side in ("jax", "port"):
        split = tmp_path / side / "eigen"
        split.mkdir(parents=True)
        (split / "test_files.txt").write_text(
            "\n".join(f"{FOLDER} {f} l" for f in frames))
    jax_export(str(tmp_path / "kitti"), "eigen", str(tmp_path / "jax"))
    out = export_gt_depth.main(["--data_path", str(tmp_path / "kitti"),
                                "--splits_dir", str(tmp_path / "port")])
    assert out == str(tmp_path / "port" / "eigen" / "gt_depths.npz")
    got = np.load(out, allow_pickle=True)["data"]
    ref = np.load(str(tmp_path / "jax" / "eigen" / "gt_depths.npz"),
                  allow_pickle=True)["data"]
    # equal-shape maps make np.array(..., dtype=object) one [N, H, W]
    # object array, in both
    assert got.dtype == ref.dtype == object
    assert got.shape == ref.shape == (len(frames), 96, 320)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  ref.astype(np.float32))
    assert all((r.astype(np.float32) > 0).sum() > 50 for r in ref)
    with pytest.raises(NotImplementedError):
        export_gt_depth.export_gt_depths(str(tmp_path / "kitti"), "ddad",
                                         str(tmp_path / "port"))


@pytest.fixture(scope="module")
def ddad_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddad")
    return str(root), [str(i) for i in _synthetic_tree(root)]


@pytest.mark.parametrize("is_train", [False, True])
def test_ddad_items_match_jax(ddad_tree, is_train):
    """Every item, every key, equal in dtype, shape and bytes; the GT depth
    maps too. Training items draw the same colour augmentation and flips."""
    root, files = ddad_tree
    frames = [0, -1, 1] if is_train else [0, -1]
    kw = dict(is_train=is_train, seed=4)
    got_ds = D.DATASETS["ddad"](root, files, 64, 96, frames, 4, **kw)
    ref_ds = JDDAD(root, files, 64, 96, frames, 4, **kw)
    assert got_ds.check_depth() == ref_ds.check_depth() is True
    for i in range(len(files)):
        got, ref = got_ds[i], ref_ds[i]
        assert set(got) == set(ref)
        for k in ref:
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            assert g.dtype == r.dtype and g.shape == r.shape, k
            assert g.tobytes() == r.tobytes(), k
        for flip in (False, True):
            np.testing.assert_array_equal(
                got_ds.get_depth(files[i], 0, None, flip),
                ref_ds.get_depth(files[i], 0, None, flip))


def test_eval_config_matches_jax():
    """The DDAD preset and the forced 320x480 (384x640, the preset's, under
    --eval_native_res), field for field as the JAX eval_config."""
    for native in (False, True):
        got = evaluate_ddad.eval_config(Config(eval_native_res=native))
        ref = jax_eval_config(JConfig(eval_native_res=native))
        assert (got.height, got.width) == ((384, 640) if native else (320, 480))
        assert (got.dataset, got.split, got.eval_split) == ("ddad",) * 3
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("median", [True, False])
def test_metrics_at_ddad_clamp_match_jax(median):
    """evaluate_disps on the "ddad" split (no crop) at max_val 200, with GT
    beyond 80 m: the JAX metrics bit for bit."""
    rng = np.random.RandomState(3)
    disps = (rng.rand(3, 20, 30) * 0.3 + 0.005).astype(np.float32)
    gts = [np.where(rng.rand(60, 90) < 0.3, rng.rand(60, 90) * 190 + 1,
                    0).astype(np.float32) for _ in range(3)]
    kw = dict(eval_split="ddad", min_val=1e-3, max_val=evaluate_ddad.MAX_VAL,
              disable_median_scaling=not median,
              pred_depth_scale_factor=1.0 if median else 5.4)
    got = M.evaluate_disps(disps.copy(), gts, **kw)
    ref = JM.evaluate_disps(disps.copy(), gts, **kw)
    assert np.isfinite(ref[0]).all()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    clamped = M.evaluate_disps(disps.copy(), gts, **dict(kw, max_val=80.0))
    assert not np.array_equal(clamped[0], got[0])  # the clamp matters


def test_evaluate_ddad_cli_on_cpu(ddad_tree, monkeypatch):
    """`python -m ppeadepth_tpu_torch.evaluate_ddad` on the tiny model at
    its native 64x96: every val_index sample once, its GT from depth/,
    run_eval at max_val 200; 7 finite metrics."""
    root, files = ddad_tree
    seen = {}
    run_eval = E.run_eval

    def spy(*a, **kw):
        seen.update(kw)
        return run_eval(*a, **kw)

    monkeypatch.setattr(E, "run_eval", spy)
    args = ["--data_path", root, "--rep_size", "t", "--adapter", "--height",
            "64", "--width", "96", "--eval_native_res", "--batch_size", "2",
            "--num_workers", "0", "--weights_init", "scratch"]
    errors, mono = evaluate_ddad.evaluate(parse_args(args), device="cpu")
    assert seen["max_val"] == 200.0
    assert len(seen["gt_depths"]) == len(files)
    assert errors.shape == (7,) and np.isfinite(errors).all()
    assert mono is None


def test_missing_gt_names_the_port_export(tmp_path):
    """Without gt_depths.npz, `--eval` tells the user to run the port's own
    export, with the split and the splits directory."""
    opt = TINY.replace(eval_split="eigen")
    with pytest.raises(FileNotFoundError) as err:
        E.load_gt_depths(opt, splits_dir=str(tmp_path))
    msg = str(err.value)
    assert "python -m ppeadepth_tpu_torch.export_gt_depth" in msg
    assert "ppeadepth_tpu.export_gt_depth" not in msg
    assert "--split eigen" in msg and str(tmp_path) in msg
    assert os.path.join(str(tmp_path), "eigen", "gt_depths.npz") in msg
