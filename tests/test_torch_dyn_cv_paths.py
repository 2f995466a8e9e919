"""The port's dyn `forward_multi` (`--dyn_cv`) of the tiny RepDepth
(rep_size "t", 64x96) against JAX in f32, and the port's paths that reach
the DynamicDepth volume: serving, the eval pass, and the stage-1 and
stage-2 training steps, on the CPU (split from tests/test_torch_dyn_cv.py,
which holds the volume's own checks, so that no port test file queues
ahead of tests/test_train_step.py under pytest-xdist's file scheduling).
The lookup images carry black patches, so the occlusion in-fill fires.
This file holds the slice's JAX compile.
"""

import numpy as np
import pytest
import torch

from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.ops import cost_volume as CV
from tests.test_torch_dyn_cv import AUG, B, _K, _pose, black_patches
from tests.torch_parity import (
    TINY, compile_reference, jax_repdepth, nhwc_to_torch)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


DYN = TINY.replace(dyn_cv=True, cv_pool=True)


@pytest.fixture(scope="module")
def dyn_inputs():
    rng = np.random.RandomState(11)
    img = rng.rand(B, DYN.height, DYN.width, 3).astype(np.float32)
    lk = np.roll(img, (1, 3), axis=(1, 2)) * 0.9 + 0.1 * rng.rand(*img.shape)
    lk = np.where(black_patches(rng, img.shape) == 0, 0, lk).astype(np.float32)
    K, invK = _K(DYN.height // 4, DYN.width // 4)
    T = np.stack([_pose(rng) for _ in range(B)])
    return img, lk, T, K, invK


def test_dyn_forward_multi_matches_jax(dyn_inputs):
    """The student forward under --dyn_cv --cv_pool with aug_mask [0, 1]:
    disparity within 2e-4 (f32 through the tiny net, as
    tests/test_torch_student.py), lowest-cost disparity within 1e-6
    relative and the confidence mask equal, on the same weights."""
    params, stats = jax_repdepth()
    img, lk, T, K, invK = dyn_inputs
    model = JRepDepth(DYN)

    def fn(v, img, lk, T, K, invK, aug):
        out, low, conf = model.apply(v, img, lk[:, None], T[:, None], K, invK,
                                     0.1, 10.0, False, aug_mask=aug,
                                     method=JRepDepth.forward_multi)
        return out[("disp", 0)], low, conf

    args = ({"params": params, "batch_stats": stats}, img, lk, T, K, invK,
            AUG)
    jdisp, jlow, jconf = (np.asarray(r)
                          for r in compile_reference(fn, *args)(*args))
    port = RepDepth(DYN).eval()
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out, low, conf = port.forward_multi(
            nhwc_to_torch(img), nhwc_to_torch(lk)[:, None],
            torch.from_numpy(T)[:, None], torch.from_numpy(K),
            torch.from_numpy(invK), 0.1, 10.0,
            aug_mask=torch.from_numpy(AUG))
    np.testing.assert_array_equal(conf.numpy(), jconf)
    np.testing.assert_allclose(low.numpy(), jlow, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out[("disp", 0)].permute(0, 2, 3, 1).numpy(),
                               jdisp, rtol=0, atol=2e-4)


@pytest.mark.parametrize("path", ["serve", "eval", "stage1", "stage2"])
def test_dyn_paths_reach_the_dyn_volume(path, monkeypatch):
    """Serving (`predict_depth_multi`), the eval pass (`predict_disps`) and
    the stage-1 and stage-2 training steps run the dyn volume under
    --dyn_cv, once per student forward, and never kernel C's wrapper;
    their outputs are finite."""
    from ppeadepth_tpu_torch.eval import evaluator
    from ppeadepth_tpu_torch.serve import InferenceSession
    from tests.test_torch_train_semantics import _tiny_step

    calls = {"dyn": 0, "sweep": 0}
    dyn, sweep = CV.plane_sweep_cost_volume_dyn, CV.plane_sweep

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(CV, "plane_sweep_cost_volume_dyn", count("dyn", dyn))
    monkeypatch.setattr(CV, "plane_sweep", count("sweep", sweep))
    opt = DYN.replace(drop_path_rate=0.0)
    rng = np.random.RandomState(2)
    img = rng.rand(B, opt.height, opt.width, 3).astype(np.float32)
    lk = np.where(black_patches(rng, img.shape) == 0, 0, np.roll(img, 3, 2))
    K, invK = _K(opt.height // 4, opt.width // 4)
    if path == "serve":
        sess = InferenceSession(opt, device="cpu", dtype="float32")
        out = sess.predict_depth_multi(img, lk.astype(np.float32), K, invK)
        want = 1
    elif path == "eval":
        model = RepDepth(opt)
        init_weights(model, torch.Generator().manual_seed(0))
        batch = {("color", 0, 0): img, ("color", -1, 0): lk.astype(np.float32),
                 ("K", 2): K, ("inv_K", 2): invK}
        out, _ = evaluator.predict_disps(
            model, opt.replace(post_process=True), [batch], device="cpu")
        want = 2  # the image and its flip
    else:
        if path == "stage2":
            opt = opt.replace(dc=True, dec_id=1)
        _, metrics = _tiny_step(opt)
        out = np.array([v.item() for v in metrics.values()])
        want = 1
    assert np.isfinite(out).all()
    assert calls == {"dyn": want, "sweep": 0}
