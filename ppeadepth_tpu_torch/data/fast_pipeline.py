"""The fast input pipeline of `--fast_pipeline` (JAX counterpart:
data/fast_pipeline.py): native JPEG decode and resize on the host, the
rest on the card.

Host, per batch: the B x |frames| JPEGs decoded and resized by the
threaded native core (`data/native_loader`, or the memory-mapped
`--decode_cache`) into u8 [B, H, W, 3] a frame, and the normalised K.
Card: `prepare_batch` uploads the u8 frames from pinned memory, scales
them to [0, 1] and applies `data/augment.augment_batch`: jitter, flip,
pyramid and intrinsics, in place of the dataset's per-item PIL work.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import dist
from . import native_loader as NL
from .augment import augment_batch, sample_jitter_factors
from .loader import rank_share as _rank_share
from .mono_dataset import MonoDataset


class FastDecodePipeline:
    """Wraps any MonoDataset subclass that exposes get_image_path()
    (KITTI-style layouts) and decodes whole batches natively.

    Yields (frames: {f: u8 [B, H, W, 3]}, K_full: [B, 4, 4] normalised),
    numpy, in the JAX pipeline's order for a seed and epoch. Missing
    neighbour frames decode to zeros (the blank-frame protocol: zeros ->
    zero pose -> cost-volume skip). One pool of 2 threads lives as long as
    the pipeline (`close` ends it) and decodes the next epoch's first
    batches while the last ones of this epoch train.
    """

    def __init__(
        self,
        dataset: MonoDataset,
        batch_size: int,
        frame_idxs: Sequence[int] = (0, -1, 1),
        shuffle: bool = True,
        n_threads: int = 16,
        drop_last: bool = True,
        seed: int = 0,
        cache_dir: str = "",
        rank: int = 0,
        world: int = 1,
    ):
        NL.library()  # build it now: a failed build raises here
        self.ds = dataset
        self.batch_size = batch_size
        # data parallelism: this rank decodes its rows of each global batch
        self.rank, self.world = rank, world
        self.frame_idxs = list(frame_idxs)
        self.shuffle = shuffle
        self.n_threads = n_threads
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._pool = cf.ThreadPoolExecutor(2)
        self._preload = {}  # epoch -> (chunk_iter, [futures])
        # --decode_cache: each image decoded once (data/decode_cache)
        self.cache = None
        if cache_dir:
            from .decode_cache import DecodeCache

            all_paths = []
            for idx in range(len(dataset)):
                folder, fi, side = dataset.index_to_folder_and_frame_idx(idx)
                for f in self.frame_idxs:
                    all_paths.append(
                        dataset.get_image_path(folder, fi + f, side))
            self.cache = DecodeCache(cache_dir, all_paths,
                                     dataset.height, dataset.width)

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close(self):
        """End the decode pool (after its pending batches)."""
        self._pool.shutdown(wait=True)

    def _paths_and_K(self, indices: List[int]):
        paths = {f: [] for f in self.frame_idxs}
        Ks = []
        for idx in indices:
            folder, frame_index, side = (
                self.ds.index_to_folder_and_frame_idx(idx)
            )
            for f in self.frame_idxs:
                paths[f].append(
                    self.ds.get_image_path(folder, frame_index + f, side)
                )
            Ks.append(self.ds.load_intrinsics(folder, frame_index))
        return paths, np.stack(Ks)

    def _epoch_chunks(self, epoch: int):
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed * 9973 + epoch)
            rng.shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        chunks = [order[i: i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        return [_rank_share(c, self.rank, self.world) for c in chunks]

    def _make(self, indices):
        H, W = self.ds.height, self.ds.width
        paths, K = self._paths_and_K(list(indices))
        if self.cache is not None:
            frames = {
                f: self.cache.get_batch(p, self.n_threads)
                for f, p in paths.items()
            }
        else:
            frames = {
                f: NL.decode_resize_batch(p, W, H, self.n_threads)
                for f, p in paths.items()
            }
        return frames, K

    def __iter__(self):
        pool = self._pool
        if self.epoch in self._preload:
            # submitted while the previous epoch's last steps ran
            it, pending = self._preload.pop(self.epoch)
        else:
            it = iter(self._epoch_chunks(self.epoch))
            pending = []
            for _ in range(2):
                try:
                    pending.append(pool.submit(self._make, next(it)))
                except StopIteration:
                    break
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(pool.submit(self._make, next(it)))
            except StopIteration:
                if not pending:
                    # warm the next epoch across the restart boundary
                    nxt = self.epoch + 1
                    nit = iter(self._epoch_chunks(nxt))
                    npend = []
                    for _ in range(2):
                        try:
                            npend.append(
                                pool.submit(self._make, next(nit)))
                        except StopIteration:
                            break
                    self._preload = {nxt: (nit, npend)}
            yield fut.result()


def prepare_batch(frames_u8: Dict[int, np.ndarray], K_full: np.ndarray,
                  generator: torch.Generator, height: int, width: int,
                  num_scales: int = 4, color_scales: Optional[int] = None,
                  device=None) -> Dict:
    """The augmented training batch on `device` (the generator's when
    None) from one `FastDecodePipeline` batch: the u8 frames uploaded (from
    pinned memory to a card), / 255, and `augment_batch` with factors drawn
    from `generator`. color_scales=1 leaves out the image pyramids the
    training step never reads. Under data parallelism the factors are
    drawn for the global batch and this rank takes its rows."""
    device = torch.device(device if device is not None else generator.device)

    def upload(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    frames = {f: upload(v).float() / 255.0 for f, v in frames_u8.items()}
    B = next(iter(frames.values())).shape[0]
    factors = sample_jitter_factors(generator, B * dist.world(), device)
    factors = {k: dist.rank_rows(v) for k, v in factors.items()}
    return augment_batch(frames, upload(K_full).float(), factors, height,
                         width, num_scales, color_scales)
