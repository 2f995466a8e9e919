"""How the port builds its native loader and picks its process group, on
the CPU (no JAX here):

  * the loader builds from `ppeadepth_tpu_torch/` alone: its own copy of
    the source, the vendored libjpeg-turbo headers by `-I`, the libjpeg
    that the installed Pillow bundles linked by path with its directory as
    the run path, and no `-ljpeg`; the library's name covers that libjpeg;
  * with no bundled libjpeg, or no Pillow, the build raises and runs no
    compiler (there is no fallback);
  * `parallel.dist`: NCCL on the cards unless PPEA_DIST_BACKEND=gloo, gloo
    on the CPU; the card rule (LOCAL_RANK under NCCL, LOCAL_RANK modulo the
    cards under gloo); `init_from_env` sets that card before the group and
    does not retry a failed NCCL group as gloo; and a world-1 gloo group on
    the CPU.

The decode against the JAX binding, byte for byte, is in
tests/test_torch_fast_pipeline.py.
"""

import importlib.util
import re
import subprocess
from pathlib import Path

import pytest
import torch

from ppeadepth_tpu_torch.data import native_loader as NL
from ppeadepth_tpu_torch.parallel import dist
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

PACKAGE = Path(__file__).resolve().parents[1] / "ppeadepth_tpu_torch"
HEADERS = ("jpeglib.h", "jerror.h", "jmorecfg.h", "jconfig.h")


def _dynamic(path):
    """(NEEDED entries, RUNPATH) of a shared library, by readelf."""
    out = subprocess.run(["readelf", "-d", str(path)], capture_output=True,
                         text=True, check=True).stdout
    needed = [ln.split("[")[1].rstrip("]") for ln in out.splitlines()
              if "(NEEDED)" in ln]
    runpath = [ln.split("[")[1].rstrip("]") for ln in out.splitlines()
               if "(RUNPATH)" in ln or "(RPATH)" in ln]
    return needed, runpath


def test_loader_builds_from_port_sources():
    assert NL.SOURCE == PACKAGE / "csrc" / "loader.cc" and NL.SOURCE.is_file()
    assert NL.JPEG_INCLUDE == PACKAGE / "third_party" / "libjpeg-turbo"
    for name in HEADERS + ("copyright",):
        assert (NL.JPEG_INCLUDE / name).is_file(), name
    assert "#define JPEG_LIB_VERSION  62" in (
        NL.JPEG_INCLUDE / "jconfig.h").read_text()
    libjpeg = NL.find_libjpeg()
    site = Path(importlib.util.find_spec("PIL").origin).parents[1]
    assert libjpeg.parent.parent == site
    assert libjpeg.parent.name in NL.PILLOW_LIB_DIRS
    assert ".so.62" in libjpeg.name
    cmd = NL.command("out.so", libjpeg)
    assert f"-I{NL.JPEG_INCLUDE}" in cmd and "-ljpeg" not in cmd
    assert str(libjpeg) in cmd and f"-Wl,-rpath,{libjpeg.parent}" in cmd
    assert all("/native/" not in arg for arg in cmd)
    path = NL.build()
    assert path == NL.library_path(libjpeg) and path.parent == NL.BUILD_DIR
    needed, runpath = _dynamic(path)
    assert libjpeg.name in needed and "libjpeg.so.62" not in needed
    assert str(libjpeg.parent) in runpath


def test_library_name_covers_the_libjpeg(tmp_path):
    a, b = tmp_path / "a" / "libjpeg.so.62", tmp_path / "b" / "libjpeg.so.62"
    assert NL.library_path(a) != NL.library_path(b)
    assert NL.library_path(a) == NL.library_path(a)


@pytest.mark.parametrize("missing", ["bundled libjpeg", "Pillow"])
def test_build_raises_without_libjpeg(monkeypatch, tmp_path, missing):
    if missing == "Pillow":
        monkeypatch.setattr(NL.importlib.util, "find_spec", lambda name: None)
        message = "Pillow is not installed"
    else:
        monkeypatch.setattr(NL, "PILLOW_LIB_DIRS", ("no_such.libs",))
        message = re.escape("found no libjpeg*.so.62* in ")

    def no_compiler(*a, **kw):
        raise AssertionError("the build ran a command without a libjpeg")

    monkeypatch.setattr(NL.subprocess, "run", no_compiler)
    monkeypatch.setattr(NL, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match=message) as err:
        NL.build()
    if missing != "Pillow":
        assert "no_such.libs" in str(err.value)
    assert not (tmp_path / "native").exists()


def test_backend_choice():
    assert dist.backend_for("cuda", {}) == "nccl"
    assert dist.backend_for("cuda", {"PPEA_DIST_BACKEND": "nccl"}) == "nccl"
    assert dist.backend_for("cuda", {"PPEA_DIST_BACKEND": "gloo"}) == "gloo"
    assert dist.backend_for("cpu", {}) == "gloo"
    assert dist.backend_for("cpu", {"PPEA_DIST_BACKEND": "gloo"}) == "gloo"
    with pytest.raises(ValueError, match="nccl or gloo"):
        dist.backend_for("cuda", {"PPEA_DIST_BACKEND": "mpi"})
    with pytest.raises(ValueError, match="needs the cards"):
        dist.backend_for("cpu", {"PPEA_DIST_BACKEND": "nccl"})


def test_card_rule():
    assert [dist.card_for(r, 1, "gloo") for r in range(3)] == [0, 0, 0]
    assert [dist.card_for(r, 4, "gloo") for r in range(6)] == [0, 1, 2, 3, 0, 1]
    assert [dist.card_for(r, 4, "nccl") for r in range(4)] == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="PPEA_DIST_BACKEND=gloo"):
        dist.card_for(1, 1, "nccl")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dist.card_for(0, 0, "gloo")


def _torchrun_env(monkeypatch, rank, world, **extra):
    env = dict(PPEA_DISTRIBUTED="1", RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT="1",
               **extra)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_init_sets_the_card_and_never_switches(monkeypatch, backend):
    """init_from_env("cuda") on a faked 2-card machine makes the rule's
    card current before the group starts: under gloo rank 3 of 4 takes
    card 1; under NCCL rank 1 takes card 1, and its failing group raises
    after one attempt."""
    calls = []
    monkeypatch.setattr(dist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))

    def init_process_group(b):
        calls.append(("init", b))
        if b == "nccl":
            raise RuntimeError("nccl: no card here")

    monkeypatch.setattr(dist.dist, "init_process_group", init_process_group)
    if backend == "gloo":
        _torchrun_env(monkeypatch, 3, 4, PPEA_DIST_BACKEND="gloo")
        assert dist.init_from_env("cuda")
    else:
        _torchrun_env(monkeypatch, 1, 2)
        with pytest.raises(RuntimeError, match="nccl: no card here"):
            dist.init_from_env("cuda")
    assert calls == [("set_device", 1), ("init", backend)]


def test_world1_gloo_group_on_the_cpu(monkeypatch):
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    _torchrun_env(monkeypatch, 0, 1, PPEA_DIST_BACKEND="gloo")
    monkeypatch.setenv("MASTER_PORT", str(port))
    dist.collective_counts.clear()
    assert dist.init_from_env("cpu")
    try:
        assert dist.enabled() and dist.world() == 1 and dist.is_main()
        assert dist.dist.get_backend() == "gloo"
        t = torch.arange(4.0)
        assert dist.all_reduce_sum_(t) is t
        assert t.tolist() == [0.0, 1.0, 2.0, 3.0]
        assert dist.collective_counts["all_reduce"] == 1
    finally:
        dist.shutdown()
    assert not dist.enabled()
