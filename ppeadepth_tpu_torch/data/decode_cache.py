"""Decoded-frame cache for `--decode_cache DIR` (JAX counterpart:
data/decode_cache.py, whose layout this keeps): each training image is
decoded once and every later read served from a memory-mapped u8 array.

Layout: one flat memmap `decoded_<fp>.u8` of [n_unique, H, W, 3] u8, a
`present` byte map beside it, and a `meta.json` pinning (n, H, W,
fingerprint) of the sorted unique path list, so a cache of another split
or resolution is rebuilt instead of reused. Rows are written at most once
each by the decoding thread that misses them (a concurrent double decode
of one row writes the same bytes).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from . import native_loader as NL


class DecodeCache:
    def __init__(self, cache_dir: str, paths: Sequence[str],
                 height: int, width: int):
        self.h, self.w = height, width
        uniq = sorted(set(paths))
        self.index: Dict[str, int] = {p: i for i, p in enumerate(uniq)}
        n = len(uniq)
        fp = hashlib.md5(
            ("\n".join(uniq) + f"|{height}x{width}").encode()
        ).hexdigest()
        os.makedirs(cache_dir, exist_ok=True)
        base = os.path.join(cache_dir, f"decoded_{fp[:16]}")
        self.data_path = base + ".u8"
        self.present_path = base + ".present"
        meta_path = base + ".meta.json"
        meta = {"n": n, "height": height, "width": width, "fp": fp}
        fresh = True
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    fresh = json.load(f) != meta
            except (OSError, ValueError):
                fresh = True
        if fresh:
            # allocate sparse files (ftruncate): pages materialize as rows
            # are written, so an unused cache costs ~nothing on disk
            with open(self.data_path, "wb") as f:
                f.truncate(n * height * width * 3)
            with open(self.present_path, "wb") as f:
                f.truncate(n)
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        self.data = np.memmap(self.data_path, np.uint8, "r+",
                              shape=(n, height, width, 3))
        self.present = np.memmap(self.present_path, np.uint8, "r+",
                                 shape=(n,))

    def get_batch(self, paths: List[str], n_threads: int) -> np.ndarray:
        """Cached rows read from the memmap; misses decoded natively (one
        threaded batch call) and written back. Returns u8 [N, H, W, 3]."""
        rows = np.asarray([self.index[p] for p in paths], np.int64)
        present = self.present[rows].astype(bool)
        out = np.empty((len(paths), self.h, self.w, 3), np.uint8)
        if present.any():
            out[present] = self.data[rows[present]]
        if not present.all():
            miss = np.flatnonzero(~present)
            decoded = NL.decode_resize_batch(
                [paths[i] for i in miss], self.w, self.h, n_threads)
            out[miss] = decoded
            for k, i in enumerate(miss):
                self.data[rows[i]] = decoded[k]
            self.present[rows[miss]] = 1
        return out
