"""Build and load the port's hand-written CUDA kernels.

All sources under `ppeadepth_tpu_torch/csrc/` compile with nvcc into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), loaded with ctypes. The library is built at first use into
`build/kernels/` at the repository root, named by a hash of the sources and
flags so an edited source is rebuilt, and written under a temporary name
then renamed so concurrent processes never load a half-written file.

Pointer and stream arguments are declared `c_void_p`: left undeclared,
ctypes would pass each Python int as a 32-bit C int and cut the address.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("lk_dwconv.cu", "ffn_fused.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, bias, y, B, H, W, C, K, stream
    "ppea_lk_dwconv_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, out, w1, b1, w2, b2, a1, ab1, a2, ab2, part, M, C, H4, CA,
    # splits, chunks_per_split, stream
    "ppea_ffn_fused_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P),
}

_lib = None
build_log: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (on PATH or under /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if no build of these sources exists;
    returns its path. Records the compile time and ptxas report in
    `build_log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libppea_kernels_{_digest()}.so"
    if lib_path.exists():
        build_log.setdefault("seconds", 0.0)
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    build_log["seconds"] = time.perf_counter() - t0
    build_log["command"] = " ".join(cmd)
    build_log["ptxas"] = proc.stderr
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
