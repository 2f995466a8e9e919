"""The fast pipeline's device augmentation (`data.augment.augment_batch`)
against the JAX package's on the same jitter and flip factors, at every
colour-pyramid depth, on the CPU. Split from
tests/test_torch_fast_pipeline.py (the native decode, the pipeline's
batches and the decode cache), so that every port test file stays behind
tests/test_train_step.py in pytest-xdist's file queue. No compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.data import augment as jax_augment
from ppeadepth_tpu_torch.data import augment
from tests.test_torch_fast_pipeline import B, COLOR_ATOL, H, W
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


K_RTOL = 1e-6  # the pinv of a 4x4 K (SVD) in each package


def _factors(rng):
    """Jitter factors as numpy: item 0 flipped and jittered, item 1 neither,
    items 2-3 mixed; every op order differs."""
    return {
        "brightness": rng.uniform(0.8, 1.2, B).astype(np.float32),
        "contrast": rng.uniform(0.8, 1.2, B).astype(np.float32),
        "saturation": rng.uniform(0.8, 1.2, B).astype(np.float32),
        "hue": rng.uniform(-0.1, 0.1, B).astype(np.float32),
        "order": np.stack([rng.permutation(4) for _ in range(B)]).astype(np.int32),
        "do_jitter": np.array([True, False, True, True]),
        "do_flip": np.array([True, False, False, True]),
    }


@pytest.mark.parametrize("color_scales", [1, 2, 3, 4])
def test_augment_batch_matches_jax(monkeypatch, color_scales):
    """Every output of `augment_batch` against JAX's on the same frames
    and factors (JAX's draw replaced by them); frame -1 of item 3 is
    blank and stays zero."""
    rng = np.random.RandomState(color_scales)
    frames = {f: rng.rand(B, H, W, 3).astype(np.float32) for f in (0, -1, 1)}
    frames[-1][3] = 0.0
    K = np.tile(np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                          [0, 0, 0, 1]], np.float32), (B, 1, 1))
    fac = _factors(rng)
    monkeypatch.setattr(jax_augment, "sample_jitter_factors",
                        lambda key, n: {k: jnp.asarray(v) for k, v in fac.items()})
    with jax.disable_jit():
        ref = jax_augment.augment_batch(
            {f: jnp.asarray(v) for f, v in frames.items()}, jnp.asarray(K),
            jax.random.PRNGKey(0), H, W, 4, color_scales)
    got = augment.augment_batch(
        {f: torch.from_numpy(v) for f, v in frames.items()},
        torch.from_numpy(K), {k: torch.from_numpy(v) for k, v in fac.items()},
        H, W, 4, color_scales)
    assert sorted(got, key=str) == sorted(ref, key=str)
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape, k
        if k[0] in ("K", "inv_K"):
            np.testing.assert_allclose(got[k].numpy(), r, rtol=K_RTOL,
                                       atol=1e-7, err_msg=str(k))
        else:
            np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                       atol=COLOR_ATOL, err_msg=str(k))
    assert not got[("color_aug", -1, 0)][3].any()
    np.testing.assert_array_equal(got[("color", 0, 0)][0].numpy(),
                                  frames[0][0][:, ::-1])
    np.testing.assert_array_equal(got[("color_aug", 0, 0)][1].numpy(),
                                  frames[0][1])
