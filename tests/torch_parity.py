"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs and weights come from numpy seeds and pass between JAX and torch as
numpy arrays. `perturb` randomises what initialisation leaves at zero or
identity (adapter `D_fc2`, BN statistics) so folding and adapter bugs
cannot hide, as tests/test_ffn_mxu.py:27-46 does. `jax_repdepth` draws the
whole JAX RepDepth tree once per process; `compile_reference` compiles a
JAX reference function with XLA's cheaper backend settings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.models import RepDepth
from ppeadepth_tpu.options import Config
from ppeadepth_tpu.train.trainer import synthetic_batch

# the tiny teacher the port's parity tests share
TINY = Config(adapter=True, rep_size="t", height=64, width=96)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread in a module that imports this fixture:
    the tiny CPU nets gain nothing from more, and the suite's parallel
    workers would otherwise oversubscribe the cores with spinning threads
    while JAX compiles its references. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, rng, path=()):
    """Copy of a flax variable tree as numpy, with BN statistics and
    adapter D_fc2 kernels redrawn from `rng`."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = perturb(v, rng, p)
        elif k == "mean":
            out[k] = rng.randn(*v.shape).astype(np.float32) * 0.05
        elif k == "var":
            out[k] = rng.rand(*v.shape).astype(np.float32) * 0.4 + 0.8
        elif "D_fc2" in p and k == "kernel":
            out[k] = rng.randn(*v.shape).astype(np.float32) * 0.05
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def jax_shapes(opt=TINY):
    """The shapes of the whole JAX RepDepth's variables (jax.eval_shape of
    its init, no compile), once per process and opt."""
    return jax.eval_shape(lambda: RepDepth(opt).init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1),
         "aug": jax.random.PRNGKey(2)},
        synthetic_batch(opt, 1), 0.1, 10.0, False))


@functools.lru_cache(maxsize=None)
def jax_repdepth(opt=TINY, seed=0):
    """(params, batch_stats) of the whole JAX RepDepth (student, teacher and
    pose nets) as numpy, drawn by `random_tree` over `jax_shapes(opt)`, once
    per process and (opt, seed); the arrays are read-only, as every caller
    shares them."""
    shapes = jax_shapes(opt)
    rng = np.random.RandomState(seed)
    return (random_tree(shapes["params"], rng),
            random_tree(shapes["batch_stats"], rng))


def random_tree(shapes, rng):
    """A flax variable tree of numpy arrays over the shapes of `shapes`:
    LeCun-normal kernels, and biases, BN scales and statistics, and adapter
    D_fc2 kernels drawn away from their zero or identity init so folding
    and adapter bugs cannot hide. Read-only arrays."""

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            scale = (0.05 if any(p.key == "D_fc2" for p in path)
                     else np.prod(shape[:-1]) ** -0.5)
            a = rng.randn(*shape) * scale
        elif name == "scale":
            a = 1 + 0.1 * rng.randn(*shape)
        elif name in ("bias", "mean"):
            a = 0.05 * rng.randn(*shape)
        else:
            assert name == "var", name
            a = rng.rand(*shape) * 0.4 + 0.8
        a = a.astype(np.float32)
        a.setflags(write=False)
        return a

    return jax.tree_util.tree_map_with_path(draw, shapes)


def compile_reference(fn, *args):
    """`fn` jitted and compiled for `args` with XLA's backend optimisation
    level 0: a JAX reference compiles in about 30 % less time; the f32
    results differ from the default build's by rounding only."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def nhwc_to_torch(a):
    """numpy NHWC -> torch NCHW view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def torch_to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def strip(sd, prefix):
    """Sub-state_dict under `prefix.` with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


KITTI_FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


def kitti_set(root, n_items, n_test, seed=0, gt=True):
    """A synthetic KITTI raw set on disk under `root` (Path), like
    tests/test_trainer_e2e.py's: random 188x620 jpgs for frames 0 ..
    n_items + 1 in the KITTI layout, the split "tiny" with `n_items`
    training lines (frames 1 .. n_items, each with both neighbours) and
    the first `n_test` as test lines, and (gt) a random gt_depths.npz of
    the test items (depths of 1-70 m at ~30 % of the pixels). Returns
    (data_path, splits_dir) as strings."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    data = root / "kitti" / KITTI_FOLDER / "image_02" / "data"
    data.mkdir(parents=True)
    for f in range(n_items + 2):
        Image.fromarray((rng.rand(188, 620, 3) * 255).astype(np.uint8)).save(
            str(data / f"{f:010d}.jpg"))
    split = root / "splits" / "tiny"
    split.mkdir(parents=True)
    lines = [f"{KITTI_FOLDER} {i} l" for i in range(1, n_items + 1)]
    (split / "train_files.txt").write_text("\n".join(lines))
    (split / "test_files.txt").write_text("\n".join(lines[:n_test]))
    if gt:
        depth = rng.rand(n_test, 188, 620) * 69 + 1
        mask = rng.rand(n_test, 188, 620) < 0.3
        np.savez(str(split / "gt_depths.npz"),
                 data=np.where(mask, depth, 0).astype(np.float32))
    return str(root / "kitti"), str(root / "splits")


CS_CITY = "aachen"


def cityscapes_set(root, n_train, n_test, seed=0, gt=True):
    """Synthetic CityScapes sets on disk under `root` (Path), like
    tests/test_trainer_stage2_e2e.py's: (1) ManyDepth-preprocessed
    training triplets, one wide jpg of three 96x160 frames (-1, 0, +1) side
    by side and a `_cam.txt` per frame, in `root`/cs; (2) the
    `cityscapes_eval` layout in `root`/cs_eval: 128x256 `leftImg8bit/test`
    frames, their frame -2 in `leftImg8bit_sequence/test`, and the camera
    JSONs; (3) the split "cityscapes_preprocessed" with `n_train` training
    and `n_test` test lines, and (gt) `n_test` random 1024x2048 GT depths
    (1-70 m at ~30 % of the pixels) as splits/cityscapes/gt_depths/
    NNN_depth.npy. Returns (training path, eval path, splits_dir) as
    strings."""
    import json

    from PIL import Image

    rng = np.random.RandomState(seed)
    train = root / "cs" / CS_CITY
    train.mkdir(parents=True)
    fh, fw = 96, 160
    cam = np.array([200.0, 0.0, fw / 2, 0.0, 210.0, fh / 2, 0.0, 0.0, 1.0])
    frames = [f"{CS_CITY}_000000_{19 + 30 * i:06d}" for i in range(
        max(n_train, n_test))]
    for frame in frames[:n_train]:
        wide = (rng.rand(fh, 3 * fw, 3) * 255).astype(np.uint8)
        Image.fromarray(wide).save(str(train / f"{frame}.jpg"))
        np.savetxt(str(train / f"{frame}_cam.txt"), cam[None], delimiter=",")
    ev = root / "cs_eval"
    dirs = {k: ev / k / "test" / CS_CITY for k in
            ("leftImg8bit", "leftImg8bit_sequence")}
    camera = ev / "camera_trainvaltest" / "camera" / "test" / CS_CITY
    for d in (*dirs.values(), camera):
        d.mkdir(parents=True)
    for frame in frames[:n_test]:
        city, seq, num = frame.split("_")
        prev = f"{city}_{seq}_{int(num) - 2:06d}"
        for d, name in ((dirs["leftImg8bit"], frame),
                        (dirs["leftImg8bit_sequence"], prev)):
            Image.fromarray((rng.rand(128, 256, 3) * 255).astype(np.uint8)).save(
                str(d / f"{name}_leftImg8bit.png"))
        intr = {"fx": 2262.5, "fy": 2265.3, "u0": 1096.98, "v0": 513.137}
        (camera / f"{frame}_camera.json").write_text(json.dumps({"intrinsic": intr}))
    split = root / "splits" / "cityscapes_preprocessed"
    split.mkdir(parents=True)
    (split / "train_files.txt").write_text(
        "\n".join(f"{CS_CITY} {f}" for f in frames[:n_train]))
    (split / "test_files.txt").write_text(
        "\n".join(f"{CS_CITY} {f}" for f in frames[:n_test]))
    if gt:
        gt_dir = root / "splits" / "cityscapes" / "gt_depths"
        gt_dir.mkdir(parents=True)
        for i in range(n_test):
            depth = rng.rand(1024, 2048) * 69 + 1
            mask = rng.rand(1024, 2048) < 0.3
            np.save(str(gt_dir / f"{i:03d}_depth.npy"),
                    np.where(mask, depth, 0).astype(np.float32))
    return str(root / "cs"), str(ev), str(root / "splits")
