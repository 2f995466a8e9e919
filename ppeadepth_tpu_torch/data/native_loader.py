"""ctypes binding to the native JPEG decode + resize core
(`native/loader.cc`, framework-free C++ over libjpeg; JAX counterpart:
data/native_loader.py).

The library is built with g++ at first use into `build/native/` at the
repository root, named by a hash of the source and flags, and written
under a temporary name then renamed, as `kernels/build.py` builds the
CUDA kernels; the JAX binding's own build next to the source is left
alone. A failed build raises with the compiler's message: there is no
fallback decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
LINK_FLAGS = ("-ljpeg", "-pthread")

_lock = threading.Lock()
_lib = None
build_log: dict = {}


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libppea_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this source exists; returns
    its path and records the compile time in `build_log`."""
    path = library_path()
    if path.exists():
        build_log.setdefault("seconds", 0.0)
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = str(Path(tmp_dir) / path.name)
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), *LINK_FLAGS]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"the native loader needs g++: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)
    build_log["seconds"] = time.perf_counter() - t0
    build_log["command"] = " ".join(cmd)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_ubyte)
            lib.ppea_decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8]
            lib.ppea_decode_resize.restype = ctypes.c_int
            lib.ppea_decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, u8, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.ppea_decode_resize_batch.restype = ctypes.c_int
            _lib = lib
    return _lib


def decode_resize(path: str, width: int, height: int) -> np.ndarray:
    """Decode a JPEG and resize it to (height, width): u8 [H, W, 3] RGB."""
    out = np.empty((height, width, 3), np.uint8)
    rc = library().ppea_decode_resize(
        path.encode(), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        raise FileNotFoundError(f"decode failed ({rc}): {path}")
    return out


def decode_resize_batch(paths: List[str], width: int, height: int,
                        n_threads: int = 8) -> np.ndarray:
    """Decode and resize a list of JPEGs on `n_threads` native threads:
    u8 [N, height, width, 3]; a file that fails to decode gives zeros (the
    blank-frame protocol of missing neighbours)."""
    n = len(paths)
    out = np.empty((n, height, width, 3), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    library().ppea_decode_resize_batch(
        arr, n, width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out
