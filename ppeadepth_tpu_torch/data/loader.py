"""Multithreaded batching loader (JAX counterpart: data/loader.py, whose
`DataLoader` this copies so both give the same batches in the same order).

Decode/augment runs in a thread pool (PIL/numpy release the GIL for the
heavy parts), batches are stacked numpy dicts, and `device_prefetch`
overlaps the host-to-device copy with compute. Deterministic: per-item RNG
is derived from (seed, epoch, index) inside the dataset, so
shuffling/workers don't change augmentations (unlike the reference, which
relies on worker-process seeding — trainer.py:78-81).

Under data parallelism each rank builds the loader with its `rank` and
the `world` size, and loads its share of every batch (`rank_share`) of
the one order that the seed and epoch give every rank.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def rank_share(idxs, rank: int, world: int):
    """Rank `rank`'s share of one batch's indices: the slice [rank * n,
    (rank + 1) * n), n = ceil(len / world) (a short last batch may leave a
    rank nothing)."""
    n = -(-len(idxs) // world)
    return idxs[rank * n:(rank + 1) * n]


def _stack(items) -> Dict:
    out = {}
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items], axis=0)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        drop_last: bool = True,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.rank, self.world = rank, world
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def batch_indices(self):
        """The dataset indices of this rank's batches in the epoch's order
        (empty shares left out)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed * 100_003 + self.epoch)
            rng.shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        shares = [rank_share(order[i : i + self.batch_size], self.rank,
                             self.world)
                  for i in range(0, len(order), self.batch_size)]
        return [s for s in shares if len(s)]

    def __iter__(self) -> Iterator[Dict]:
        def fetch(idx):
            return self.dataset.__getitem__(int(idx), epoch=self.epoch)

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            batch_idx = self.batch_indices()
            # pipeline: keep a couple of batches in flight
            pending = []
            it = iter(batch_idx)
            for _ in range(2):
                try:
                    idxs = next(it)
                    pending.append([pool.submit(fetch, i) for i in idxs])
                except StopIteration:
                    break
            while pending:
                futs = pending.pop(0)
                try:
                    idxs = next(it)
                    pending.append([pool.submit(fetch, i) for i in idxs])
                except StopIteration:
                    pass
                yield _stack([f.result() for f in futs])


def _step_inputs(batch: Dict) -> Dict:
    """The batch without the colour pyramids (scale >= 1), which the
    training step never reads (JAX train/trainer.py:286-293)."""
    return {k: v for k, v in batch.items()
            if not (isinstance(k, tuple) and k[0] in ("color", "color_aug")
                    and k[2] > 0)}


def device_prefetch(iterator, device, size: int = 2):
    """Yield the training batches of `iterator` (stacked numpy dicts) as
    tensors on `device`, without the colour pyramids of scale >= 1.

    A producer thread keeps up to `size` batches ahead: on a card it copies
    each array from pinned host memory with `non_blocking=True` on a copy
    stream of its own, and the consumer's stream waits for that copy before
    the batch is yielded, so the upload of the next batch overlaps the
    step on this one. On the CPU the arrays are wrapped as they are. An
    exception in the producer is raised in the consumer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(batch):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in _step_inputs(batch).items()}
        if copy_stream is None:
            return batch, None
        with torch.cuda.stream(copy_stream):
            batch = {k: v.pin_memory().to(device, non_blocking=True)
                     for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return batch, ready

    def producer():
        try:
            for b in iterator:
                q.put(place(b))
        except BaseException as e:  # handed to the consumer, which raises
            q.put(e)
        finally:
            q.put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            break
        if isinstance(item, BaseException):
            raise item
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for v in batch.values():
                v.record_stream(stream)
        yield batch
    t.join()
