"""ctypes binding to the native JPEG decode + resize core
(`csrc/loader.cc`, framework-free C++ over libjpeg; JAX counterpart:
data/native_loader.py, which builds its own copy in native/).

The library is built with g++ at first use into `build/native/` at the
repository root, named by a hash of the source, the flags and the libjpeg
it links, and written under a temporary name then renamed, as
`kernels/build.py` builds the CUDA kernels. It compiles against the
libjpeg-turbo 2.1.5 headers vendored in `third_party/libjpeg-turbo/`
(libjpeg's 6.2 ABI, `JPEG_LIB_VERSION` 62) and links, by path, the libjpeg
`.so.62` that the installed Pillow wheel bundles (`pillow.libs/`), with
that directory as its run path: the same recipe on every machine, with no
system libjpeg or its headers needed. A failed build, or a Pillow without
a bundled libjpeg, raises: there is no fallback decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE / "csrc" / "loader.cc"
JPEG_INCLUDE = PACKAGE / "third_party" / "libjpeg-turbo"
BUILD_DIR = PACKAGE.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
# the directories a Pillow wheel keeps its bundled libraries in, beside PIL/
PILLOW_LIB_DIRS = ("pillow.libs", "Pillow.libs")

_lock = threading.Lock()
_lib = None
build_log: dict = {}


def find_libjpeg() -> Path:
    """The libjpeg `.so.62` of the installed Pillow wheel: the first, by
    name, of `libjpeg*.so.62*` in the wheel's library directory beside
    `PIL/`. Raises, naming where it looked, if there is none."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        raise RuntimeError("the native loader links the libjpeg that Pillow "
                           "bundles, and Pillow is not installed")
    site = Path(spec.origin).resolve().parents[1]
    dirs = [site / d for d in PILLOW_LIB_DIRS]
    for d in dirs:
        found = sorted(d.glob("libjpeg*.so.62*"))
        if found:
            return found[0]
    raise RuntimeError("the native loader links the libjpeg that Pillow "
                       "bundles, and found no libjpeg*.so.62* in "
                       + " or ".join(map(str, dirs)))


def command(out: str, libjpeg: Path) -> List[str]:
    """The g++ command that builds the library into `out`, linking the
    libjpeg at `libjpeg` by path with its directory as the run path."""
    return ["g++", *CXX_FLAGS, f"-I{JPEG_INCLUDE}", "-o", out, str(SOURCE),
            str(libjpeg), f"-Wl,-rpath,{libjpeg.parent}", "-pthread"]


def library_path(libjpeg: Path | None = None) -> Path:
    """Where the library of this source, these flags, these headers and
    this libjpeg (`find_libjpeg()` by default) lives."""
    libjpeg = find_libjpeg() if libjpeg is None else libjpeg
    h = hashlib.sha256(" ".join(command("", libjpeg)).encode())
    for f in (SOURCE, *sorted(JPEG_INCLUDE.glob("*.h"))):
        h.update(f.read_bytes())
    return BUILD_DIR / f"libppea_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this source exists; returns
    its path and records the compile time and command in `build_log`."""
    libjpeg = find_libjpeg()
    path = library_path(libjpeg)
    if path.exists():
        build_log.setdefault("seconds", 0.0)
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = str(Path(tmp_dir) / path.name)
        cmd = command(tmp, libjpeg)
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
