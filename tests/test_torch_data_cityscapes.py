"""The port's CityScapes loaders and dataset registry against the JAX
package: `CityscapesPreprocessedDataset` (training triplets) and
`CityscapesEvalDataset` batches byte for byte through the port's
`DataLoader`, both epochs, and the dataset names. Split from
tests/test_torch_data.py (the KITTI loader), so that every port test file
stays behind tests/test_train_step.py in pytest-xdist's file queue.
"""

import random

import numpy as np
import pytest

from ppeadepth_tpu import data as JD
from ppeadepth_tpu_torch import data as D
from tests.torch_parity import cityscapes_set


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """(training path, eval path, the 9 lines of the split) of a synthetic
    CityScapes set with 9 training and 9 test frames."""
    train, ev, splits = cityscapes_set(tmp_path_factory.mktemp("cs"), 9, 9,
                                       gt=False)
    with open(f"{splits}/cityscapes_preprocessed/train_files.txt") as fh:
        return train, ev, fh.read().split("\n")


def _cs_batches(mod, cityscapes, name, is_train, epoch):
    train, ev, files = cityscapes
    frames = [0, -1, 1] if is_train else [0, -1]
    ds = mod.DATASETS[name](train if name == "cityscapes_preprocessed" else ev,
                            files, 64, 96, frames, 4, is_train=is_train, seed=3)
    loader = mod.DataLoader(ds, 4, shuffle=is_train, num_workers=2,
                            drop_last=is_train, seed=5)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("name,is_train", [
    ("cityscapes_preprocessed", True), ("cityscapes_preprocessed", False),
    ("cityscapes_eval", False)])
def test_cityscapes_batches_match_jax(cityscapes, name, is_train, epoch):
    """Both CityScapes datasets give the JAX package's bytes, every key:
    training triplets with colour augmentation and flips live on some
    items, and the eval layout's frames 0 and -2 (as frame -1) with the
    camera JSON's intrinsics, its partial last batch kept."""
    got = _cs_batches(D, cityscapes, name, is_train, epoch)
    ref = _cs_batches(JD, cityscapes, name, is_train, epoch)
    assert len(got) == len(ref) == (2 if is_train else 3)
    for b, r in zip(got, ref):
        assert set(b) == set(r)
        assert {k[1] for k in r if k[0] == "color"} == (
            {-1, 0, 1} if name == "cityscapes_preprocessed" else {-1, 0})
        for k in r:
            assert b[k].dtype == r[k].dtype and b[k].shape == r[k].shape, k
            assert np.array_equal(b[k], r[k]), k
    if is_train:
        # the per-item draws of mono_dataset.__getitem__: colour
        # augmentation, then the flip; both happen on some item
        draws = []
        for i in range(len(cityscapes[2])):
            rng = random.Random((3 * 1_000_003 + epoch) * len(cityscapes[2]) + i)
            draws.append((rng.random() > 0.5, rng.random() > 0.5))
        assert any(a for a, _ in draws) and any(f for _, f in draws)
        aug = np.concatenate([b[("color_aug", 0, 0)] for b in got])
        plain = np.concatenate([b[("color", 0, 0)] for b in got])
        assert (np.abs(aug - plain).max(axis=(1, 2, 3)) > 0).any()
    else:
        assert got[-1][("color", 0, 0)].shape[0] == 1


@pytest.mark.parametrize("name", ["ddad"])
def test_dataset_names_match_jax(name):
    """Every name of JAX's DATASETS maps to the port's class of the same
    name, and `name`, the last one to be ported, builds."""
    ds = D.DATASETS[name]("x", [], 64, 96, [0], 4)
    assert len(ds) == 0 and not ds.check_depth()
    assert set(D.DATASETS) == set(JD.DATASETS)
    for key, cls in JD.DATASETS.items():
        assert D.DATASETS[key].__name__ == cls.__name__, key
