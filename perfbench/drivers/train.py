"""The driver of the training loops ``fit`` and ``fit_sequences`` (the
configuration's family names which): one timed call, as a production user
makes it.

Set-up makes the leaves and the data from the seed on the card, then
drives the run's first epoch through the window's own call in two calls,
each resuming the last one's checkpoint: the first step alone, a call
over one batch (the loop's budget is whole epochs), whose state gives the
first gradient; then the rest of the epoch over the whole set, cut into
windows at the log interval as the timed call cuts them (the resumed first
step, then the steps to the epoch's edge: one chained window of the
loader's own batches), validating and checkpointing at the edge.  The
losses the calls report, the state after the first step and the leaves
after the epoch are the program's readings; the reference follows the
same steps on the same rows, the loader's order worked out again by the
family (``batch_rows``).  The timed call resumes the checked run and
trains the traffic's ``epochs_per_second`` times ``--seconds`` epochs
over the whole set (a fixed amount of work), validating, logging and
checkpointing as the traffic says.

The traffic's ``rate_metric`` is every sample (sequence, for
``fit_sequences``) the timed call trained over its wall time, from call to
return.  In a traced run the profiler covers two whole log intervals in
the middle of the call, the device alone over the first and the host's
launches over the second, started and stopped at their edges by the
loop's own ``lr_schedule`` hook (which hands back the constant rate, so
the numbers are those of a run without it).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from perfbench.checks import (Readings, compare_training, first_grad_of,
                              reference_steps)


class Driver:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.opt = tr["optimizer"]
        self.batch = int(tr["batch_size"])
        self.log_epochs = int(tr["log_every_epochs"])
        self.ckpt_every = int(tr.get("checkpoint_every", 0))
        self.validate = bool(tr.get("validate", False))
        self.epochs_per_s = float(tr["epochs_per_second"])
        self.rate_metric = tr["rate_metric"]

    # -- inputs: the same for the program and the reference --------------

    def inputs(self):
        ctx = self.ctx
        gen = ctx.generator()
        self.leaves0 = ctx.ref.make_params(ctx.cfg, gen, ctx.device)
        d = ctx.ref.make_data(ctx.cfg, gen, ctx.device, **ctx.data_sizes)
        host = {"X": d["X"].cpu().numpy(), "Y": d["Y"].cpu().numpy()}
        if self.validate:
            host["Xv"], host["Lv"] = d["Xv"].cpu().numpy(), d["Lv"].cpu().numpy()
        N, B = host["X"].shape[0], self.batch
        self.spe = ctx.family.steps_per_epoch(N, B)
        # the rows of the checked epoch: the first call's one batch, then
        # the loader's own batches of its steps 1 .. spe-1
        self.rows = ([np.arange(B)]
                     + ctx.family.batch_rows(ctx.seed, N, B, self.spe)[1:])
        self.ref_data = (host["X"], host["Y"])
        return host

    def _batches(self, half: bool = False):
        """The checked epoch's batches on the device, one at a time
        (``half``: the first half of each)."""
        X, Y = (torch.from_numpy(a).to(self.ctx.device)
                for a in self.ref_data)
        for idx in self.rows:
            i = torch.from_numpy(idx[:max(1, len(idx) // 2)] if half
                                 else idx).to(self.ctx.device)
            yield X[i], Y[i]

    # -- the program -------------------------------------------------------

    def _call(self, data, **kw):
        ctx = self.ctx
        return ctx.family.fit(self.net0, self.loss, self.be, data, self.opt,
                              batch_size=self.batch, seed=ctx.seed,
                              verbose=False, **kw)

    def setup(self):
        from tensor_ops_tpu_torch import TorchBackend

        ctx = self.ctx
        self.host = self.inputs()
        ctx.program_begins()
        self.be = TorchBackend(torch.float32, ctx.device)
        self.loss = ctx.family.loss(ctx.cfg)
        self.net0 = ctx.family.build(ctx.cfg, self.be, self.leaves0)
        B, spe = self.batch, self.spe
        self.log_every = spe * self.log_epochs
        if self.ckpt_every % self.log_every:
            raise ValueError("checkpoint_every must be a multiple of the log "
                             "interval, so that windows start at log edges")
        self.path = os.path.join(ctx.tmp, "run")
        with ctx.spans.span("fit.first_epoch"):
            # the first step: a call over the first batch alone
            part = {k: v[:B] for k, v in self.host.items() if k in ("X", "Y")}
            res = self._call(part, epochs=1, checkpoint_path=self.path,
                             checkpoint_every=1, log_every=1)
            self.state1 = dict(np.load(self.path + ".state"))
            self.leaves1 = [t.detach().double().cpu() for t in
                            ctx.family.leaves(res.net)]
            losses = {0: float(res.history[0]["loss"])}
            # the rest of the epoch over the whole set, in the timed call's
            # windows, checkpointed at the epoch's edge
            res = self._call(self.host, epochs=1, checkpoint_path=self.path,
                             checkpoint_every=spe, resume=True,
                             log_every=self.log_every, lr_schedule=self._rate)
            losses.update((r["step"] - 1, float(r["loss"]))
                          for r in res.history)
        self.loss_steps = sorted(losses)
        self.prog_losses = [losses[s] for s in self.loss_steps]
        self.leaves_n = [t.detach().double().cpu()
                         for t in ctx.family.leaves(res.net)]
        self.nonfinite = sum(not math.isfinite(v) for v in self.prog_losses)
        self.epochs = 1 + max(4 * self.log_epochs,
                              round(ctx.seconds * self.epochs_per_s))

    def _rate(self, s):
        return self.ctx.family.rate_of(self.opt)

    def _hook(self, s):
        """Called for every step of a window as the window starts: at a
        window's first step, mark it, and start or stop the trace there."""
        L = self.log_every
        if s % L == 0 or s == self.spe + 1:
            self.ctx.spans.mark("fit: window edge (log boundary, val, "
                                "checkpoint, table upload)")
            tr = self.ctx.tracer
            if tr is not None:
                if tr.running and s >= self.trace_stop:
                    tr.stop()
                    # the next part (or this one again, if it read nothing)
                    # over the next log interval
                    if not tr.done and s + L <= self.epochs * self.spe:
                        self.trace_start, self.trace_stop = s, s + L
                if not tr.running and not tr.done and s == self.trace_start:
                    tr.start()
        return self._rate(s)

    def window(self):
        ctx = self.ctx
        mid = (self.epochs * self.spe) // 2
        self.trace_start = max(self.log_every, mid - mid % self.log_every)
        self.trace_stop = self.trace_start + self.log_every
        t0 = time.perf_counter()
        with ctx.spans.span("fit"):
            res = self._call(self.host, epochs=self.epochs,
                             checkpoint_path=self.path,
                             checkpoint_every=self.ckpt_every, resume=True,
                             log_every=self.log_every, lr_schedule=self._hook)
        wall = time.perf_counter() - t0
        if ctx.tracer is not None and ctx.tracer.running:
            ctx.tracer.stop()  # a part the call's last edge did not end
        steps = res.steps - self.spe
        N = self.host["X"].shape[0]
        samples = sum(ctx.family.rows_of_step(s, N, self.batch)
                      for s in range(self.spe, res.steps))
        self.nonfinite += sum(not math.isfinite(r["loss"])
                              for r in res.history)
        work = ctx.ref.work(ctx.cfg, "train_step", rows=self.batch,
                            optimizer=self.opt["kind"])
        obs = {"kind": "train", "attempted": steps,
               "failed": steps if self.nonfinite else 0,
               "e2e": {self.rate_metric: samples / wall},
               "first_step_s": res.history[0]["t"],
               "trace": ctx.tracer.data if ctx.tracer else None,
               "steps_traced": self.log_every,
               "samples_traced": self.log_every * self.batch,
               "work_step": work,
               "flops_per_sample": work["flops"] / self.batch}
        del res
        return obs

    def release(self):
        self.net0 = self.be = self.host = None

    # -- the comparison ----------------------------------------------------

    def program_readings(self) -> Readings:
        ctx = self.ctx
        n_states = ctx.ref.n_states(ctx.cfg)
        grad1 = []
        for k in range(len(self.leaves0)):
            m = (torch.from_numpy(self.state1[f"o_{1 + k}"])
                 if self.opt["kind"] == "adam" else None)
            g = first_grad_of(self.opt, k, n_states, self.leaves0[k].cpu(),
                              self.leaves1[k], m)
            grad1.append(float(torch.linalg.vector_norm(g)))
        change = [float(torch.linalg.vector_norm(p - s.double().cpu()))
                  for p, s in zip(self.leaves_n, self.leaves0)]
        return Readings(self.prog_losses, grad1, change)

    def reference_readings(self, prec: str, half: bool = False) -> Readings:
        return reference_steps(self.ctx.ref, self.ctx.cfg, self.leaves0,
                               self._batches(half), self.opt, prec,
                               losses_of=self.loss_steps)

    def check(self):
        numbers = compare_training(self.program_readings(),
                                   self.reference_readings("f64"))
        numbers["nonfinite_losses"] = float(self.nonfinite)
        return numbers

    def control(self, kind: str = "tf32"):
        """Readings of a side put in the program's place, against the
        reference in float64, on this seed's inputs: the control (the
        reference in TF32), or the fault ``"half_batch"`` (each step's
        mean gradient over the first half of its batch)."""
        self.inputs()
        self.loss_steps = [0, 1, self.spe - 1]
        ref = self.reference_readings("f64")
        if kind == "tf32":
            return compare_training(self.reference_readings("tf32"), ref)
        if kind != "half_batch":
            raise ValueError(f"no fault {kind!r}")
        return compare_training(self.reference_readings("f64", half=True),
                                ref)
