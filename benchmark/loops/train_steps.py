"""Mix kind `train_steps`: the program's training step driven back to
back over a pool of batches resident on the device, one unit a step.

Set-up builds the step with its model and optimizer state and makes its
first `check` steps through the window's own call; the check reads them
against the reference's steps on the same weights, batches, draws and
drop-path masks (`harness/check.py`). End to end: images a second over
the window, and the peak of allocated memory in it."""

import torch

from harness import check, program, traffic

DTYPES = {"bfloat16": "bf16", "float32": "f32"}


class Loop:
    unit_name = "train_step"

    def __init__(self, port, cell, sd, seed, device):
        o, mix = cell["config"]["options"], cell["traffic"]
        self.port, self.device, self.sd = port, device, sd
        self.opt = opt = program.config(port, cell["config"])
        self.batch = mix["batch"]
        self.dtype = DTYPES[o["compute_dtype"]]
        with torch.device(device):
            model = port["RepDepth"](opt)
        model.load_state_dict(sd, strict=True)
        st = port["step"]
        self.state = st.create_train_state(
            model, opt, device=device,
            generator=torch.Generator(device).manual_seed(program.sub_seed(seed, 1)))
        self.optim, sched = port["schedule"].make_optimizer(
            [p for p in model.parameters() if p.requires_grad],
            opt.learning_rate, steps_per_epoch=mix["steps_per_epoch"])
        self.model = model
        self.train_step = st.make_train_step(model, opt, self.optim, sched)
        gen = torch.Generator(device).manual_seed(program.sub_seed(seed, 2))
        H, W = o["height"], o["width"]
        self.pool = traffic.train_pool(gen, mix, H, W, device)
        self.draws = [traffic.draws(gen, mix, H, W, device)
                      for _ in range(mix["pool"])]
        self.made = (self.pool, self.draws)  # what the reference is given
        self.drop_seed = program.sub_seed(seed, 3)
        self.drop_gen = torch.Generator(device).manual_seed(self.drop_seed)
        self.k = 0

    def passes(self):
        """What a unit is made of, for `harness/model_pass.py`."""
        return [{"pass": "train", "batch": self.batch, "form": "train",
                 "dtype": self.dtype}]

    def unit(self):
        i = self.k % len(self.pool)
        d = self.draws[i]
        self.state, metrics = self.train_step(
            self.state, self.pool[i],
            self.port["step"].StepDraws(d["aug_u"], d["noise_mono"],
                                        d["noise_multi"], self.drop_gen))
        self.k += 1
        return metrics

    def warm_up(self, n_check):
        """The first steps, through the window's own call, read for the
        check: losses, the first gradient from Adam's first moment, the
        changes of parameters, BN statistics and bins."""
        params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        losses, parts = [], []
        for i in range(n_check):
            m = self.unit()
            losses.append(m["loss"])
            parts.append((m["mono/loss"], m["multi/loss"]))
            if i == 0:
                # no moment where the optimizer never stepped: a zero gradient
                grad = {n: self.optim.state.get(p, {}).get(
                            "exp_avg", torch.zeros(())).norm() / (1 - check.BETA1)
                        for n, p in params.items()}
        self.readings = {
            "loss": [float(v) for v in losses],
            "parts": [[float(a), float(b)] for a, b in parts],
            "grad": check.floats(grad),
            "update": check.floats(check.norms_of_change(params, self.sd)),
            "bn": check.floats(check.norms_of_change(
                check.bn_buffers(self.model.named_buffers()), self.sd)),
            "bins": (float(self.state.min_depth_bin) - 0.1,
                     float(self.state.max_depth_bin) - 10.0)}

    def free(self):
        del self.model, self.optim, self.train_step, self.state

    def numbers(self, cell, n_check):
        pool, draws = self.made
        ref = check.reference_train(cell["config"], self.sd, pool[:n_check],
                                    draws[:n_check], self.drop_seed,
                                    self.opt.learning_rate, self.device)
        return check.compare_train(self.readings, ref)

    def end_to_end(self, n, seconds, peak):
        return {"train_img_s": (n * self.batch / seconds, "images/s"),
                "train_peak_gib": (peak / 2 ** 30, "GiB")}
