"""The port's evaluation against the JAX package's: the numpy metric pass
(`eval/metrics`, a copy) on random inputs, `load_gt_depths`, and
`run_eval` on the same checkpoint and data, rep "t", 64x96, B=2, f32,
with the flip post-process and the teacher. The JAX eval step is the
file's one compile, built once per module with
`torch_parity.compile_reference` and handed to the JAX `run_eval`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.eval import evaluator as J
from ppeadepth_tpu.eval import metrics as JM
from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu_torch import data as D
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.eval import evaluator as E
from ppeadepth_tpu_torch.eval import metrics as M
from ppeadepth_tpu_torch.models import RepDepth
from tests.torch_parity import (
    TINY, cityscapes_set, compile_reference, jax_repdepth, kitti_set)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

OPT = TINY.replace(post_process=True, eval_split="tiny", split="tiny",
                   batch_size=2)
BINS = (0.5, 20.0)


@pytest.mark.parametrize("median", [True, False])
@pytest.mark.parametrize("split", ["eigen", "tiny"])
def test_metrics_match_jax(median, split):
    """evaluate_disps (resize, crop, median scaling, clamp, 7 errors),
    the post-process blend and the printed table: equal bit for bit."""
    rng = np.random.RandomState(1)
    disps = (rng.rand(3, 24, 80) * 0.3 + 0.01).astype(np.float32)
    gts = [np.where(rng.rand(90, 300) < 0.4, rng.rand(90, 300) * 60 + 1,
                    0).astype(np.float32) for _ in range(3)]
    kw = dict(eval_split=split, disable_median_scaling=not median,
              pred_depth_scale_factor=1.0 if median else 5.4)
    got = M.evaluate_disps(disps.copy(), gts, **kw)
    ref = JM.evaluate_disps(disps.copy(), gts, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    blended = M.batch_post_process_disparity(disps, disps[:, :, ::-1])
    np.testing.assert_array_equal(
        blended, JM.batch_post_process_disparity(disps, disps[:, :, ::-1]))
    assert M.format_metrics(got[0]) == JM.format_metrics(ref[0])
    assert M.METRIC_NAMES == JM.METRIC_NAMES


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both run_evals on one synthetic set (4 test images, 2 batches: one
    shape, one compile), the same weights and bins: {name: (errors,
    teacher errors, student disparities, teacher disparities)}."""
    root, splits = kitti_set(tmp_path_factory.mktemp("eval"), 4, 4)
    files = open(f"{splits}/tiny/test_files.txt").read().split("\n")
    ds = D.KITTIRAWDataset(root, files, OPT.height, OPT.width, [0, -1], 4)
    batches = list(D.DataLoader(ds, OPT.batch_size, shuffle=False,
                                num_workers=2, drop_last=False))
    gt = E.load_gt_depths(OPT, splits_dir=splits)
    params, stats = jax_repdepth()
    variables = {"params": params, "batch_stats": stats}

    step = J.make_eval_step(JRepDepth(OPT), OPT, True)
    bins = tuple(jnp.asarray(b, jnp.float32) for b in BINS)
    compiled = compile_reference(
        step, variables, {k: jnp.asarray(v) for k, v in batches[0].items()},
        *bins)
    jax_out = []

    def jax_step(v, batch, lo, hi):
        jax_out.append(compiled(v, batch, lo, hi))
        return jax_out[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(J, "make_eval_step", lambda *a: jax_step)
    try:
        jerr, jmono = J.run_eval(JRepDepth(OPT), variables, OPT, iter(batches),
                                 *bins, with_teacher=True, gt_depths=gt)
    finally:
        mp.undo()
    jd = np.concatenate([np.asarray(d) for d, _ in jax_out])
    jmd = np.concatenate([np.asarray(m) for _, m in jax_out])

    model = RepDepth(OPT)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    captured = []
    predict = E.predict_disps
    mp.setattr(E, "predict_disps",
               lambda *a, **kw: captured.append(predict(*a, **kw)) or captured[-1])
    try:
        err, mono = E.run_eval(model, OPT, iter(batches), *BINS,
                               with_teacher=True, splits_dir=splits, device="cpu")
    finally:
        mp.undo()
    return {"jax": (jerr, jmono, jd, jmd), "port": (err, mono, *captured[0])}


def _unit(scaled):
    """Scaled disparity (disp_to_depth(1e-3, 80)) -> the network's sigmoid
    disparity in [0, 1], where the parity tests' 2e-4 applies."""
    lo, hi = 1 / E.MAX_VAL, 1 / E.MIN_VAL
    return (scaled - lo) / (hi - lo)


def test_run_eval_disparities_match_jax(runs):
    """Student (with its flipped pass) and teacher disparities of every
    image within 2e-4 in [0, 1] units."""
    _, _, jd, jmd = runs["jax"]
    _, _, d, md = runs["port"]
    assert d.shape == jd.shape == (4, 2, 64, 96) and md.shape == jmd.shape
    np.testing.assert_allclose(_unit(d), _unit(jd), rtol=0, atol=2e-4)
    np.testing.assert_allclose(_unit(md), _unit(jmd), rtol=0, atol=2e-4)


def test_run_eval_metrics_match_jax(runs):
    """The 7 metrics of the student and the teacher within 1e-4 relative."""
    for got, ref in zip(runs["port"][:2], runs["jax"][:2]):
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


def test_load_gt_depths_matches_jax(tmp_path):
    _, splits = kitti_set(tmp_path, 2, 2)
    got = E.load_gt_depths(OPT, splits_dir=splits)
    ref = J.load_gt_depths(OPT, splits_dir=splits)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(FileNotFoundError, match="export_gt_depth"):
        E.load_gt_depths(OPT.replace(eval_split="none"), splits_dir=splits)


@pytest.mark.parametrize("median", [True, False])
def test_cityscapes_gt_and_metrics_match_jax(tmp_path, median):
    """CityScapes: `load_gt_depths` reads splits/cityscapes/gt_depths/
    NNN_depth.npy (all of them, or the first `num`) as the JAX package
    does, and `evaluate_disps` (the 75 % ego-car crop, the [256:, 192:1856]
    window, median scaling, clamp) gives JAX's metrics bit for bit on
    1024x2048 GT."""
    _, _, splits = cityscapes_set(tmp_path, 0, 3)
    opt = OPT.replace(eval_split="cityscapes")
    for num in (None, 2):
        got = E.load_gt_depths(opt, num, splits_dir=splits)
        ref = J.load_gt_depths(opt, num, splits_dir=splits)
        assert len(got) == len(ref) == (num or 3)
        for g, r in zip(got, ref):
            assert g.shape == (1024, 2048)
            np.testing.assert_array_equal(g, r)
    rng = np.random.RandomState(2)
    disps = (rng.rand(3, 48, 128) * 0.3 + 0.01).astype(np.float32)
    kw = dict(eval_split="cityscapes", disable_median_scaling=not median,
              pred_depth_scale_factor=1.0 if median else 5.4)
    got = M.evaluate_disps(disps.copy(), E.load_gt_depths(opt, None, splits), **kw)
    ref = JM.evaluate_disps(disps.copy(), J.load_gt_depths(opt, None, splits), **kw)
    assert np.isfinite(ref[0]).all()
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
