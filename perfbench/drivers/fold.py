"""The driver of the mnist app's default route: per-sample SGD by
``train_fold`` over chunks of the epoch's shuffle, each chunk followed by
its training accuracy and the validation confusion matrix, as
``apps/mnist.py`` drives it (its prints left out).

The rows live on the host in float64 and each chunk is copied in, as in
the app.  Set-up makes the leaves and data from the seed, then drives the
run's first sample through the window's own call (a chunk of one row: its
update gives the first gradient) and then one whole chunk (the window's
shape, whose graph it captures): the leaves after them are the program's
readings.  The window trains on, chunk after chunk, until ``--seconds``
have passed; the traffic's ``rate_metric`` is the samples trained over
that time.  A traced run profiles two chunks, with their accuracy and
confusion, from the middle of the window: the device alone over the
first, the host's launches over the second.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.checks import (Readings, compare_training, first_grad_of,
                              reference_steps)


class Driver:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.rate = float(ctx.traffic["rate"])
        self.chunk = int(ctx.traffic["chunk"])
        self.opt = {"kind": "sgd", "rate": self.rate}
        self.rate_metric = ctx.traffic["rate_metric"]

    def inputs(self):
        ctx = self.ctx
        gen = ctx.generator()
        self.leaves0 = ctx.ref.make_params(ctx.cfg, gen, ctx.device)
        d = ctx.ref.make_data(ctx.cfg, gen, ctx.device, **ctx.data_sizes)
        # the app's rows: float64 on the host (its processDat)
        self.X = d["X"].double().cpu().numpy()
        self.Y = d["Y"].double().cpu().numpy()
        self.L = d["L"].cpu().numpy()
        self.Xv, self.Lv = d["Xv"], d["Lv"].cpu().numpy()
        self.rng = ctx.host_rng(1)
        self.perm, self.pos = self.rng.permutation(len(self.X)), 0
        n = 1 + self.chunk
        rows = self.perm[:n]
        dev = ctx.device
        self.check_batches = [
            (torch.from_numpy(self.X[i:i + 1]).to(dev),
             torch.from_numpy(self.Y[i:i + 1]).to(dev)) for i in rows]

    def take(self, n: int):
        """The next ``n`` rows of the stream of epochs, each epoch in a new
        order (the app's shuffle)."""
        idx = []
        while n:
            k = min(n, len(self.perm) - self.pos)
            idx.append(self.perm[self.pos:self.pos + k])
            self.pos += k
            n -= k
            if self.pos == len(self.perm):
                self.perm, self.pos = self.rng.permutation(len(self.X)), 0
        i = np.concatenate(idx)
        return self.X[i], self.Y[i], self.L[i]

    def setup(self):
        from tensor_ops_tpu_torch import TorchBackend

        ctx = self.ctx
        self.inputs()
        self.nonfinite = 0
        ctx.program_begins()
        self.be = TorchBackend(torch.float32, ctx.device)
        self.loss = ctx.family.loss(ctx.cfg)
        self.net = ctx.family.build(ctx.cfg, self.be, self.leaves0)
        self.vX = self.be.asarray(self.Xv)
        self.Xv = None
        with ctx.spans.span("fold.first_steps"):
            self._train(*self.take(1)[:2])
            self.leaves1 = [t.detach().double().cpu()
                            for t in ctx.family.leaves(self.net)]
            self._chunk(*self.take(self.chunk))
            self.leaves_n = [t.detach().double().cpu()
                             for t in ctx.family.leaves(self.net)]

    def _train(self, xs, ys):
        from tensor_ops_tpu_torch.models import training

        with self.ctx.spans.span("fold: copy in and train_fold"):
            xs_dev, ys_dev = self.be.asarray(xs), self.be.asarray(ys)
            self.net = training.train_fold(self.net, self.loss, self.be,
                                           self.rate, xs_dev, ys_dev)

    def _chunk(self, xs, ys, ls):
        from tensor_ops_tpu_torch.models import training

        self._train(xs, ys)
        # the app's report after each chunk (its numbers printed, not kept)
        with self.ctx.spans.span("fold: training accuracy"):
            training.accuracy(self.net, self.be, self.be.asarray(xs), ls)
        with self.ctx.spans.span("fold: validation confusion"):
            training.confusion(self.net, self.be, self.vX, self.Lv,
                               self.ctx.cfg["out"][0])

    def window(self):
        ctx = self.ctx
        tr = ctx.tracer
        samples = chunks = 0
        t0 = time.perf_counter()
        traced_at = t0 + 0.4 * ctx.seconds
        with ctx.spans.span("fold"):
            while time.perf_counter() - t0 < ctx.seconds:
                rows = self.take(self.chunk)
                trace_this = (tr is not None and not tr.done
                              and time.perf_counter() >= traced_at)
                if trace_this:
                    tr.start()
                self._chunk(*rows)
                if trace_this:
                    tr.stop()
                samples += self.chunk
                chunks += 1
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(t).all())
                     for t in ctx.family.leaves(self.net))
        self.nonfinite = 0 if finite else 1
        work = ctx.ref.work(ctx.cfg, "train_step", rows=1, optimizer="sgd")
        return {"kind": "train", "attempted": samples,
                "failed": 0 if finite else samples,
                "e2e": {self.rate_metric: samples / wall},
                "trace": tr.data if tr else None,
                "steps_traced": self.chunk, "samples_traced": self.chunk,
                "work_step": work, "flops_per_sample": work["flops"]}

    def release(self):
        self.net = self.be = self.vX = None

    def program_readings(self) -> Readings:
        grad1 = [float(torch.linalg.vector_norm(first_grad_of(
            self.opt, k, 0, p0.cpu(), p1)))
            for k, (p0, p1) in enumerate(zip(self.leaves0, self.leaves1))]
        change = [float(torch.linalg.vector_norm(p - s.double().cpu()))
                  for p, s in zip(self.leaves_n, self.leaves0)]
        return Readings([], grad1, change)

    def reference_readings(self, prec: str) -> Readings:
        return reference_steps(self.ctx.ref, self.ctx.cfg, self.leaves0,
                               self.check_batches, self.opt, prec)

    def check(self):
        numbers = compare_training(self.program_readings(),
                                   self.reference_readings("f64"))
        numbers["nonfinite_leaves"] = float(self.nonfinite)
        return numbers

    def control(self, kind: str = "tf32"):
        """Readings of a side put in the program's place, against the
        reference in float64: the control (the reference in TF32), or the
        fault ``"half_batch"`` (the first chunk's second half left out)."""
        self.inputs()
        ref = self.reference_readings("f64")
        if kind == "tf32":
            return compare_training(self.reference_readings("tf32"), ref)
        if kind != "half_batch":
            raise ValueError(f"no fault {kind!r}")
        self.check_batches = self.check_batches[:1 + self.chunk // 2]
        return compare_training(self.reference_readings("f64"), ref)
