"""The training driver: fine-tuning as the port's ``fit`` runs it on one
device, ``produce_batch`` (upload and preprocess) then ``train_step``, each
step's dropout generator seeded anew.

Set-up builds one train state from the configuration's weights, builds
the mix's pool of host batches from the seed, and drives that same state
through its first ``checked_steps`` steps (which build and warm every
kernel the window runs). It keeps what the reference is compared with:
each of those steps' loss, the logits of the first step's forward (read
by a forward hook on the model during that step alone), the norm of each
leaf's first gradient as Adam got it (its first moment after one step
over ``1 - beta1``), and the norm of each leaf's change over those steps.
The window then goes on stepping the same state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from portbench import counts, traffic
from portbench.reference import model

ADAM_BETA1 = 0.9


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of step ``step`` of a run seeded
    ``seed``."""
    return int(np.random.SeedSequence([seed, 3, step]).generate_state(
        1, np.uint64)[0] >> 1)


class Driver:
    """One run's program, its traffic and its loop."""

    def __init__(self, conf, mix, seed: int, device, hooks=None):
        from crnn_ocr_torch.data.pipeline import produce_batch
        from crnn_ocr_torch.infer.pretrained import model_weights
        from crnn_ocr_torch.infer.weights import params_from_jax
        from crnn_ocr_torch.train.state import create_train_state
        from crnn_ocr_torch.train.step import make_train_step

        self.conf, self.mix, self.seed = conf, mix, seed
        self.device = torch.device(device)
        hooks = hooks or {}
        cfg, params, stats, _ = model_weights(conf["program"]["pretrained"],
                                              conf["dtype"])
        self.cfg = dataclasses.replace(cfg,
                                       dropout_rate=conf["dropout_rate"])
        counts.check_config(self.cfg, conf)
        self.state = create_train_state(
            self.cfg, params_from_jax(params, stats), device=self.device,
            optimizer=mix["optimizer"], learning_rate=mix["learning_rate"],
            clipnorm=mix["clipnorm"])
        step_fn = make_train_step(self.cfg)
        self.train_step = hooks.get("train_step", lambda f: f)(step_fn)
        self.produce_batch = produce_batch
        classes = model.load_classes(conf, conf["_root"])
        self.host = traffic.train_batches(
            mix, seed, classes, counts.downsample(conf),
            conf["ctc_time_slice"])
        self.gen = torch.Generator(device=self.device)
        self.n_steps = 0
        self.losses: List[torch.Tensor] = []
        self.norms: List[torch.Tensor] = []  # global norms before the clip
        self.readings = self._checked_steps(mix["checked_steps"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def produce(self, k: int) -> dict:
        b = self.produce_batch(dict(self.host[k % len(self.host)]),
                               self.device, self.cfg)
        return {key: v for key, v in b.items()
                if key not in ("texts", "bucket")}

    def step(self, batch: dict) -> int:
        self.gen.manual_seed(step_seed(self.seed, self.n_steps))
        m = self.train_step(self.state, batch, self.gen)
        self.losses.append(m["loss"])
        self.norms.append(m["grad_norm"])
        self.n_steps += 1
        return int(batch["x"].shape[0])

    def call(self) -> int:
        return self.step(self.produce(self.n_steps))

    def _checked_steps(self, n: int) -> dict:
        named = dict(self.state.model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in named.items()}
        grad1, seen = {}, []
        for k in range(n):
            hook = (self.state.model.register_forward_hook(
                lambda mod, args, out: seen.append(out.detach().float()
                                                   .cpu()))
                    if k == 0 else None)
            self.call()
            if hook is not None:
                hook.remove()
            if k == 0:
                opt = self.state.optimizer.state
                grad1 = {name: float(opt[p]["exp_avg"].norm())
                         / (1 - ADAM_BETA1) if p in opt else 0.0
                         for name, p in named.items()}
        change = {k: float((p.detach() - p0[k]).norm())
                  for k, p in named.items()}
        losses = [float(x) for x in self.losses[:n]]
        norms = [float(x) for x in self.norms[:n]]
        self.losses.clear()
        self.norms.clear()
        self.sync()
        return {"losses": losses, "norms": norms, "grad1": grad1,
                "change": change, "logits1": seen[0] if seen else None}

    def window(self, seconds: float) -> dict:
        from portbench.drivers.serve import quarters

        self.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        done = []
        while time.perf_counter() < end:
            done.append((time.perf_counter(), self.call()))
        self.sync()
        wall = time.perf_counter() - t0
        return {"train_lines_per_s": sum(n for _, n in done) / wall,
                "_quarters": quarters(done, t0, wall)}

    def attempted_failed(self):
        vals = [float(x) for x in self.losses]
        return len(vals), sum(1 for v in vals if not np.isfinite(v))

    def traced_work(self) -> dict:
        lines = len(self.losses) * self.mix["batch"]
        return {"lines": lines, "flops": lines * counts.TRAIN_FACTOR
                * counts.model_flops(self.conf, self.mix["bucket"])}

    def install_spans(self, rec) -> None:
        """The benchmark's own ranges around ``produce_batch`` (the host's
        time in it, the loop as ``fit`` runs it: nothing synchronized) and
        around each recurrent layer's forward."""
        self.produce = rec.wrap("produce_batch", self.produce)
        rec.wrap_rnns(self.state.model, self.conf)

    def release(self) -> None:
        del self.state, self.train_step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, W, classes) -> dict:
        from portbench.reference import judge

        n = self.mix["checked_steps"]
        ref = model.train_steps(
            W, self.host[:n], [step_seed(self.seed, k) for k in range(n)],
            self.conf, self.mix, self.device)
        prog = dict(self.readings, lines1=model.line_losses(
            self.readings.pop("logits1"), self.host[0], self.conf,
            self.device))
        return judge.judge_train(prog, ref)
