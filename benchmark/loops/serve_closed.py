"""Mix kind `serve_closed`: the program's inference session under one
client in a closed loop, sending its next request from a pool in host
memory when the last one is answered; one unit a request.

The check reads the depth that sampled timed requests returned, at their
first and last answer in the window, against the reference's
(`harness/check.py`). End to end: images a second over the window, and
the 95th percentile of every request's latency, from the call to the
depth in hand."""

import time

import numpy as np
import torch

from harness import check, program, traffic

DTYPES = {"bfloat16": "bf16", "float32": "f32"}


class Loop:
    def __init__(self, port, cell, sd, seed, device):
        o, mix = cell["config"]["options"], cell["traffic"]
        self.device, self.sd, self.mode = device, sd, mix["mode"]
        self.batch = mix["batch"]
        self.dtype = DTYPES[o["serve_dtype"]]
        opt = program.config(port, cell["config"])
        with torch.device(device):
            self.session = port["serve"].InferenceSession(
                opt, state_dict=sd, device=device, dtype=o["serve_dtype"])
        self.fn = (self.session.predict_depth if self.mode == "teacher"
                   else self.session.predict_depth_multi)
        self.unit_name = ("predict_depth" if self.mode == "teacher"
                          else "predict_depth_multi")
        gen = torch.Generator(device).manual_seed(program.sub_seed(seed, 2))
        self.pool = traffic.serve_pool(gen, mix, o["height"], o["width"], device)
        rng = np.random.default_rng(program.sub_seed(seed, 4))
        self.checked = sorted(rng.choice(len(self.pool), mix["check"],
                                         replace=False).tolist())
        self.first, self.last = {}, {}
        self.k = 0
        self.latencies = []

    def passes(self):
        """What a unit is made of, for `harness/model_pass.py`."""
        return [{"pass": self.mode, "batch": self.batch, "form": "merged",
                 "dtype": self.dtype}]

    def unit(self):
        i = self.k % len(self.pool)
        t = time.perf_counter()
        depth = self.fn(*self.pool[i])
        self.latencies.append(time.perf_counter() - t)
        if i in self.checked:
            self.first.setdefault(i, depth)
            self.last[i] = depth
        self.k += 1

    def warm_up(self, n_check):
        for i in range(2):
            self.fn(*self.pool[i])

    def free(self):
        del self.session, self.fn

    def numbers(self, cell, n_check):
        refs = {e: check.reference_disp(cell["config"], self.sd, self.pool[e],
                                        self.mode, self.device)
                for e in self.first}
        answers = [(e, d) for src in (self.first, self.last) for e, d in src.items()]
        return check.compare_serve(answers, refs, cell["config"]["options"])

    def end_to_end(self, n, seconds, peak):
        lat = np.asarray(self.latencies[:n]) * 1e3
        return {"serve_img_s": (n * self.batch / seconds, "images/s"),
                "serve_p95_ms": (float(np.percentile(lat, 95)), "ms")}
