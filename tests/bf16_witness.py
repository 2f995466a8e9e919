"""The bf16 serving error of stage-2 weights, in the port and in JAX.

    python -m tests.bf16_witness [--height 96] [--width 256] [--strict_bf16]

`chip_smoke.py` draws the stage-2 decoder adapters non-zero
(`_stage2_state_dict`, over the calibrated `_random_state_dict`) and
holds the card's bf16 forward against the CPU f32 forward. This script
asks whether the bf16 error it sees belongs to the port or to the network:
on the same weights it runs the merged bf16 and f32 forwards of the port
(plain versions on the CPU) and of the JAX package (`InferenceSession`
with `torch_checkpoint`, lax on the CPU), teacher and student, without and
with --dyn_cv, with the adapters as drawn and zeroed, and prints each
|d disp| (mean/max) of bf16 against f32 and of port against JAX. B=2, the
lookup frames with chip_smoke's black patches. Not collected by pytest:
at rep_size b it takes minutes; it stays at a reduced resolution on a CPU.

XLA on the CPU may keep intermediates at more than their declared bf16
(`--xla_allow_excess_precision`, on by default), and then the JAX bf16
forward is more precise than a bf16 forward that rounds each op's output,
as cuDNN, the port's kernels and its plain versions do. `--strict_bf16`
turns that off (XLA_FLAGS, set before JAX starts).
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from ppeadepth_tpu_torch.serve import InferenceSession as PortSession

B = 2


def zero_decoder_adapters(sd):
    return {k: torch.zeros_like(v) if k.split(".")[0] in ("depth", "mono_depth")
            and k.endswith("weight") and ("D_fc2" in k or "deconv_adpt" in k)
            else v for k, v in sd.items()}


def main(argv=None):
    p = argparse.ArgumentParser("tests.bf16_witness")
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--strict_bf16", action="store_true")
    a = p.parse_args(argv)
    if a.strict_bf16:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false")
    from ppeadepth_tpu.options import Config as JConfig
    from ppeadepth_tpu.serve import InferenceSession as JaxSession

    H, W = a.height, a.width
    t0 = time.time()
    opt = cs.STAGE2_B.replace(height=H, width=W)
    drawn = cs._stage2_state_dict(
        cs._random_state_dict(cs.SHIPPED_B.replace(height=H, width=W)), opt)
    rng = np.random.RandomState(cs.SEED + 10)
    img = rng.rand(B, H, W, 3).astype("float32")
    lk = cs._occlude(rng, np.roll(img, (2, 5), (1, 2)))
    K, invK = cs._kitti_K(H // 4, W // 4, B)
    lo, hi = 1.0 / opt.max_depth, 1.0 / opt.min_depth
    jopt = JConfig(adapter=True, rep_size="b", height=H, width=W,
                   train_cs=True, dc=True, dec_id=1).with_mode_presets()
    print(f"rep_size b {W}x{H} B={B}, strict bf16 in XLA {a.strict_bf16}, "
          f"weights in {time.time() - t0:.1f} s", flush=True)

    def disp(d):
        return (1.0 / d - lo) / (hi - lo)

    with tempfile.TemporaryDirectory() as tmp:
        for dyn in (False, True):
            for tag, sd in (("drawn", drawn), ("zeroed", zero_decoder_adapters(drawn))):
                path = os.path.join(tmp, "model.pth")
                torch.save(sd, path)
                out = {}
                for dt in ("float32", "bfloat16"):
                    port = PortSession(opt.replace(dyn_cv=dyn, cv_pool=dyn), sd,
                                       device="cpu", dtype=dt)
                    jax = JaxSession(jopt.replace(dyn_cv=dyn, cv_pool=dyn),
                                     torch_checkpoint=path, dtype=dt)
                    for name, s in (("port", port), ("jax", jax)):
                        out[name, "student", dt] = disp(
                            s.predict_depth_multi(img, lk, K, invK))
                        out[name, "teacher", dt] = disp(s.predict_depth(img))

                def d(x, y):
                    e = np.abs(out[x] - out[y])
                    return f"{e.mean():.3e}/{e.max():.3e}"

                for net in ("teacher", "student"):
                    if dyn and net == "teacher":
                        continue
                    print(f"dyn_cv={dyn} adapters {tag} {net}: bf16 vs f32 port "
                          f"{d(('port', net, 'bfloat16'), ('port', net, 'float32'))} "
                          f"jax {d(('jax', net, 'bfloat16'), ('jax', net, 'float32'))}"
                          f"; port vs jax f32 "
                          f"{d(('port', net, 'float32'), ('jax', net, 'float32'))} "
                          f"bf16 {d(('port', net, 'bfloat16'), ('jax', net, 'bfloat16'))}",
                          flush=True)
    print(f"done in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
