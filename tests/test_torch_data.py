"""The port's data path against the JAX package's: the same files, seeds
and epochs give the same shuffle order and byte-identical batches, every
key, with colour augmentation and flips on (training) and off with a
partial last batch (evaluation), for KITTI and both CityScapes datasets
(the preprocessed training triplets and the `cityscapes_eval` layout);
`device_prefetch` hands the training batch over without its colour
pyramids; the unported DDAD dataset raises. No JAX compile."""

import random

import numpy as np
import pytest
import torch

from ppeadepth_tpu import data as JD
from ppeadepth_tpu_torch import data as D
from tests.torch_parity import KITTI_FOLDER, cityscapes_set, kitti_set

# 8 items with both neighbours, and a 9th whose +1 neighbour is missing
# (the dataset's dummy zero frame)
FILES = [f"{KITTI_FOLDER} {i} l" for i in range(1, 10)]


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return kitti_set(tmp_path_factory.mktemp("kitti"), 8, 4, gt=False)[0]


def _batches(mod, root, is_train, epoch):
    frames = [0, -1, 1] if is_train else [0, -1]
    ds = mod.KITTIRAWDataset(root, FILES, 64, 96, frames, 4, is_train=is_train,
                             seed=3)
    loader = mod.DataLoader(ds, 4, shuffle=is_train, num_workers=2,
                            drop_last=is_train, seed=5)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("is_train", [True, False])
def test_batches_match_jax(kitti, is_train, epoch):
    got = _batches(D, kitti, is_train, epoch)
    ref = _batches(JD, kitti, is_train, epoch)
    # training drops the partial batch, evaluation keeps it (9 = 4 + 4 + 1)
    assert len(got) == len(ref) == (2 if is_train else 3)
    for b, r in zip(got, ref):
        assert set(b) == set(r)
        for k in r:
            assert b[k].dtype == r[k].dtype and b[k].shape == r[k].shape, k
            assert np.array_equal(b[k], r[k]), k
    if is_train:
        # colour augmentation is live on some item
        aug = np.concatenate([b[("color_aug", 0, 0)] for b in got])
        plain = np.concatenate([b[("color", 0, 0)] for b in got])
        assert (np.abs(aug - plain).max(axis=(1, 2, 3)) > 0).any()
    else:
        assert got[-1][("color", 0, 0)].shape[0] == 1


@pytest.mark.parametrize("epoch", [0, 1])
def test_shuffle_order_matches_jax(kitti, epoch):
    """Both loaders visit the items in the order of RandomState(seed *
    100003 + epoch) and drop the last partial batch."""
    orders = []
    for mod in (D, JD):
        seen = []

        class Spy(mod.KITTIRAWDataset):
            def __getitem__(self, index, epoch=0):
                seen.append(index)
                return {"i": np.array(index)}

        loader = mod.DataLoader(Spy(kitti, FILES, 64, 96, [0], 1), 4,
                                shuffle=True, num_workers=1, seed=5)
        loader.set_epoch(epoch)
        orders.append([int(i) for b in loader for i in b["i"]])
    assert orders[0] == orders[1]
    assert len(orders[0]) == 8 and orders[0] != sorted(orders[0])


def test_device_prefetch_drops_pyramids(kitti):
    batch = _batches(D, kitti, True, 0)[0]
    out = list(D.device_prefetch(iter([batch]), "cpu"))
    assert len(out) == 1
    kept = {k for k in batch if not (k[0] in ("color", "color_aug") and k[2] > 0)}
    assert set(out[0]) == kept and ("K", 3) in kept and ("color", 1, 0) in kept
    for k in kept:
        assert torch.equal(out[0][k], torch.from_numpy(batch[k])), k


def test_device_prefetch_raises_producer_error():
    def broken():
        yield {("K", 0): np.zeros((1, 4, 4), np.float32)}
        raise OSError("decode failed")

    it = D.device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="decode failed"):
        next(it)


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
def test_unported_datasets_raise(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        D.DATASETS[name]("x", [], 64, 96, [0], 4)
