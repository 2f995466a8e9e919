"""The port's fast input pipeline (`--fast_pipeline`) against the JAX
package's on the CPU: the native decode byte for byte (one file, a batch
with a missing frame), the antialiased pyramid resize at 2x / 4x / 8x, the
jitter factors and `prepare_batch`, `FastDecodePipeline`'s batches
for one seed over two epochs, the decode cache's round trip, and the
library's build under `build/native/`. `augment_batch` against JAX's is
in tests/test_torch_augment.py.

The JAX augment runs eagerly (`jax.disable_jit`): no compile in this file.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ppeadepth_tpu.data import fast_pipeline as jax_fp
from ppeadepth_tpu.data import native_loader as jax_nl
from ppeadepth_tpu.data.kitti import KITTIRAWDataset as JKITTI
from ppeadepth_tpu_torch.data import augment, native_loader
from ppeadepth_tpu_torch.data.decode_cache import DecodeCache
from ppeadepth_tpu_torch.data.fast_pipeline import (
    FastDecodePipeline, prepare_batch)
from ppeadepth_tpu_torch.data.kitti import KITTIRAWDataset
from tests.torch_parity import kitti_set
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 96, 4
# f32 colour arithmetic in another order (the HSV round trip, the
# antialiased resize's weights): values in [0, 1]
COLOR_ATOL = 2e-6


def test_library_builds_under_build_dir():
    path = native_loader.build()
    assert path.parent == native_loader.BUILD_DIR
    assert native_loader.BUILD_DIR == Path(ROOT, "build", "native")
    assert path.name.startswith("libppea_loader_") and path.exists()
    assert native_loader.library_path() == path


def test_decode_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(((188, 620), (64, 96), (375, 1242))):
        p = str(tmp_path / f"{i}.jpg")
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
        np.testing.assert_array_equal(native_loader.decode_resize(p, W, H),
                                      jax_nl.decode_resize(p, W, H))
    paths.insert(1, str(tmp_path / "missing.jpg"))
    got = native_loader.decode_resize_batch(paths, W, H, n_threads=3)
    ref = jax_nl.decode_resize_batch(paths, W, H, n_threads=3)
    assert got.shape == (4, H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert got[1].sum() == 0 and got[0].sum() > 0
    with pytest.raises(FileNotFoundError):
        native_loader.decode_resize(paths[1], W, H)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_antialiased_resize_matches_jax(factor):
    x = np.random.RandomState(factor).rand(2, H, W, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, H // factor, W // factor, 3),
                           "linear")
    got = augment.resize_linear(torch.from_numpy(x), H // factor, W // factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=COLOR_ATOL)


def test_jitter_factors_and_prepare_batch():
    """The draws' ranges and types, and `prepare_batch`: u8 frames / 255
    through `augment_batch` with the factors the generator gives."""
    gen = torch.Generator().manual_seed(0)
    fac = augment.sample_jitter_factors(gen, 1000)
    for k, (lo, hi) in {"brightness": (0.8, 1.2), "contrast": (0.8, 1.2),
                        "saturation": (0.8, 1.2), "hue": (-0.1, 0.1)}.items():
        assert lo <= fac[k].min() and fac[k].max() <= hi, k
    assert (fac["order"].sort(dim=1).values == torch.arange(4)).all()
    for k in ("do_jitter", "do_flip"):
        assert fac[k].dtype == torch.bool and 0.4 < fac[k].float().mean() < 0.6
    rng = np.random.RandomState(1)
    frames = {f: (rng.rand(B, H, W, 3) * 255).astype(np.uint8) for f in (0, -1)}
    K = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    got = prepare_batch(frames, K, torch.Generator().manual_seed(5), H, W, 4, 1)
    want = augment.augment_batch(
        {f: torch.from_numpy(v).float() / 255.0 for f, v in frames.items()},
        torch.from_numpy(K), augment.sample_jitter_factors(
            torch.Generator().manual_seed(5), B), H, W, 4, 1)
    assert sorted(got, key=str) == sorted(want, key=str)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast")
    data_path, splits_dir = kitti_set(root, 6, 2, gt=False)
    with open(os.path.join(splits_dir, "tiny", "train_files.txt")) as f:
        files = f.read().splitlines()
    return root, data_path, files


def test_pipeline_batches_match_jax(kitti):
    """Two epochs of one seed: the same shuffled order, frames (u8, the
    missing neighbours of the first and last item blank) and K as the JAX
    pipeline's."""
    _, data_path, files = kitti
    frames_idx = [-1, 0, 1]
    files = files + ["2011_09_26/2011_09_26_drive_0001_sync 7 l"]  # no frame 8
    port = FastDecodePipeline(
        KITTIRAWDataset(data_path, files, H, W, frames_idx, 4, is_train=True),
        2, frames_idx, seed=3, n_threads=2)
    ref = jax_fp.FastDecodePipeline(
        JKITTI(data_path, files, H, W, frames_idx, 4, is_train=True),
        2, frames_idx, seed=3, n_threads=2)
    try:
        assert len(port) == len(ref) == 3
        blank = 0
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 3
            for (gf, gk), (wf, wk) in zip(got, want):
                np.testing.assert_array_equal(gk, wk)
                assert sorted(gf) == sorted(wf) == frames_idx
                for f in frames_idx:
                    np.testing.assert_array_equal(gf[f], wf[f])
                    blank += int((gf[f].reshape(2, -1).sum(1) == 0).sum())
        assert blank == 2  # frame 8 of the added item, once an epoch
    finally:
        port.close()


def test_decode_cache_round_trip(kitti, tmp_path):
    """The first read decodes and fills the memmap; a second cache on the
    same directory finds every row present and serves the same bytes;
    another resolution starts a fresh cache."""
    _, data_path, files = kitti
    ds = KITTIRAWDataset(data_path, files, H, W, [0], 4, is_train=False)
    paths = [ds.get_image_path(*ds.index_to_folder_and_frame_idx(i))
             for i in range(len(ds))]
    cache = DecodeCache(str(tmp_path), paths, H, W)
    assert not cache.present.any()
    first = cache.get_batch(paths[:3], 2)
    np.testing.assert_array_equal(
        first, native_loader.decode_resize_batch(paths[:3], W, H))
    assert cache.present.sum() == 3
    again = DecodeCache(str(tmp_path), paths, H, W)
    assert again.present.sum() == 3
    np.testing.assert_array_equal(again.get_batch(paths[:3], 2), first)
    names = sorted(os.listdir(str(tmp_path)))
    assert len(names) == 3 and names[0].endswith(".meta.json")
    other = DecodeCache(str(tmp_path), paths, H // 2, W // 2)
    assert not other.present.any()
