#!/usr/bin/env python3
"""Where a compiled call's host time goes, on one NVIDIA GPU.

    python3 tools/engine_host_path.py

``FusedMLP.train_fullfused``'s step at the flagship (784-300-100-10, B =
100, seeded weights), one kernel-3 launch, put through the engine's graph
path here (``engine.jit``; the entry point itself launches it direct):
host-clock microseconds a call (500 calls after 20, the card drained
before and after) of the whole entry point, of the compiled call by the
graph and direct (``engine.direct``), and of each piece of the graph path
alone (the flatten, the rules, the signature, the input copies, the replay
on the card's replay stream, a bare ``replay()``, the output copies, a
stream switch, an event record, one ``empty_like``, one ``copy_``); then
``cProfile`` of 500 graph-path calls.  The card's name and power limit
first.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tensor_ops_tpu_torch import engine  # noqa: E402
from tensor_ops_tpu_torch.models import FusedMLP  # noqa: E402
from tensor_ops_tpu_torch.ops import kernels as K  # noqa: E402


def timed(what: str, f, n: int = 500) -> None:
    for _ in range(20):
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        f()
    torch.cuda.synchronize()
    print(f"{what}: {(time.perf_counter() - t0) / n * 1e6:.1f} us",
          flush=True)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    r = np.random.default_rng(0)
    dims = (784, 300, 100, 10)
    ws = [np.asarray(r.normal(size=(dims[k + 1], dims[k])) / 28, np.float32)
          for k in range(3)]
    bs = [np.asarray(r.normal(size=dims[k + 1]) * 0.3, np.float32)
          for k in range(3)]
    fm = FusedMLP.from_numpy(ws, bs, ("logistic", "logistic", "identity"))
    x = torch.rand(100, 784, device="cuda")
    y = torch.eye(10, device="cuda")[
        torch.randint(0, 10, (100,), device="cuda")]
    fn = engine.jit(lambda x, y, ws, bs, rate: K.fused_mlp_train_step(
        x, y, list(ws), list(bs), rate, fm.acts), "the train_fullfused step")
    args = (x, y, fm.weights, fm.biases, 0.3)
    for _ in range(5):
        fn(*args)
    g = next(iter(fn.graphs.values()))
    leaves = engine.flatten(args)
    side = torch.cuda.Stream()

    def switch():
        with torch.cuda.stream(side):
            pass

    event = torch.cuda.Event()
    timed("train_fullfused (direct, float(v) included)",
          lambda: fm.train_fullfused(0.3, x, y))
    timed("compiled call (graph path)", lambda: fn(*args))
    with engine.direct():
        timed("compiled call (direct)", lambda: fn(*args))
    timed("flatten", lambda: engine.flatten(args))
    timed("the rules (_graph_device)", lambda: engine._graph_device(leaves))
    timed("the signature", lambda: engine._signature(args, True))
    timed("input copies (statics.fill)", lambda: g.statics.fill(leaves))
    timed("replay on the replay stream", lambda: g.captured.replay())
    timed("bare graph.replay()", lambda: g.captured.graph.replay())
    timed("output copies", lambda: engine._copies(g.outs))
    timed("a stream switch", switch)
    timed("an event record", lambda: event.record())
    timed("empty_like", lambda: torch.empty_like(x))
    timed("copy_ of x", lambda: g.statics.bufs[0].copy_(x))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(500):
        fn(*args)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
    print(out.getvalue())


if __name__ == "__main__":
    main()
