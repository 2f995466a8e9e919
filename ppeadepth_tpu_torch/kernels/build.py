"""Build and load the port's hand-written CUDA kernels.

All sources under `ppeadepth_tpu_torch/csrc/` compile with nvcc, one
process per source, all started together, and link into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
loaded with ctypes. The library is built at first use into `build/kernels/`
at the repository root, named by a hash of the sources and flags so an
edited source is rebuilt, and written under a temporary name then renamed
so concurrent processes never load a half-written file.

Pointer and stream arguments are declared `c_void_p`: left undeclared,
ctypes would pass each Python int as a 32-bit C int and cut the address.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("lk_dwconv.cu", "ffn_fused.cu", "plane_sweep.cu", "warp_border.cu")
# no --use_fast_math: kernel C's edge mask needs IEEE division and rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, bias, y, args (14 ints: lk_conv._args), stream
    "ppea_lk_dwconv_bf16": (_P, _P, _P, _P, _P, _P),
    "ppea_lk_dwconv_f32": (_P, _P, _P, _P, _P, _P),
    # x, w, bias, y, args (20 ints: lk_conv._args of a BandPlan), stream
    "ppea_lk_dwconv_banded_bf16": (_P, _P, _P, _P, _P, _P),
    # x, w_up, b_up, w_down, b_down, hidden, out, M, C, Hp, tile_up,
    # tile_down, stream
    "ppea_ffn_fused_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P),
    # cur, lk, A, t, bins, out, B, H, W, C, D, bf16, g, nv, stream
    "ppea_plane_sweep": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    "ppea_plane_sweep_fixed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    # img, coords, out, N, H, W, C, Ho, Wo, stream
    "ppea_warp_border_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # img, coords, g, dcoords, N, H, W, C, Ho, Wo, stream
    "ppea_warp_border_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
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


def _run_all(cmds):
    """Run the commands as concurrent processes and wait for every one;
    raise with the output of the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    results = []
    for cmd, p in procs:
        out, err = p.communicate()
        results.append((cmd, p.returncode, out, err))
    failed = [r for r in results if r[1] != 0]
    if failed:
        cmd, rc, out, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n{err}")
    return results


def build() -> Path:
    """Compile the kernel library if no build of these sources exists;
    returns its path. Records the compile time and ptxas report in
    `build_log` (the report is kept beside the library, so a process that
    finds the library built still has it)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libppea_kernels_{_digest()}.so"
    ptxas_path = lib_path.with_suffix(".ptxas.txt")
    if lib_path.exists():
        build_log.setdefault("seconds", 0.0)
        if ptxas_path.exists():  # built by another process: its report
            build_log.setdefault("ptxas", ptxas_path.read_text())
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [str(Path(tmp_dir) / f"{s}.o") for s in SOURCES]
        compiled = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                             for s, o in zip(SOURCES, objs)])
        tmp = str(Path(tmp_dir) / lib_path.name)
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        tmp_ptxas = Path(tmp_dir) / ptxas_path.name
        tmp_ptxas.write_text("".join(r[3] for r in compiled))
        os.replace(tmp_ptxas, ptxas_path)
        os.replace(tmp, lib_path)
    build_log["seconds"] = time.perf_counter() - t0
    build_log["command"] = "\n".join(" ".join(r[0]) for r in compiled)
    build_log["ptxas"] = "".join(r[3] for r in compiled)
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
