#!/usr/bin/env python3
"""The compiled forwards by graph against their direct calls, on one NVIDIA
GPU.

    python3 tools/forward_graph_vs_direct.py

``FusedMLP.run`` (kernel 1 a layer and the softmax), ``FusedMLP.run_xla``
(cuBLAS) and ``QuantizedMLP.run`` in w8 and w8a8 (kernel 4 or 5 a layer),
each in three arms: direct (the function itself), a graph that copies the
weights in as graph inputs (``engine.jit`` with no argument read in place)
and a graph that reads them where they lie (``in_place``, as
``FusedMLP.run_xla`` is compiled; the port runs the other three direct,
a graph making them no faster).  At the flagship (784-300-100-10, logistic, softmax out,
seeded weights) at buckets 8 and 64, and at the 4 x 4096 serving stack
(relu, softmax out) at bucket 8.  Host-clock microseconds a call, the
arms interleaved over TURNS turns of CALLS calls (the order reversed every
other turn, the card drained before and after each), the median turn; each
graph arm's static bytes (``Compiled.static_bytes``) beside the weights'
bytes; every arm bit-equal to the direct call.  The card's name and power
limit first.
"""

from __future__ import annotations

import gc
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tensor_ops_tpu_torch import engine  # noqa: E402
from tensor_ops_tpu_torch.models import FusedMLP, QuantizedMLP  # noqa: E402
from tensor_ops_tpu_torch.models import fast  # noqa: E402

TURNS, CALLS = 5, 50
FLAGSHIP = (784, 300, 100, 10)
STACK_N, STACK_L = 4096, 4


def model(dims, acts, seed):
    r = np.random.default_rng(seed)
    ws = [np.asarray(r.normal(size=(dims[k + 1], dims[k]))
                     / np.sqrt(dims[k]), np.float32)
          for k in range(len(dims) - 1)]
    bs = [np.asarray(0.1 * r.normal(size=dims[k + 1]), np.float32)
          for k in range(len(dims) - 1)]
    return FusedMLP.from_numpy(ws, bs, acts)


def forwards(fm):
    """(name, function of (x, *weights), the weights, in_place)."""
    acts, soft, prec = fm.acts, fm.softmax_out, fm.precision
    out = [("FusedMLP.run",
            lambda x, ws, bs: fast._layers(x, ws, bs, acts, soft, prec),
            (fm.weights, fm.biases), (1, 2)),
           ("FusedMLP.run_xla",
            lambda x, ws, bs: fast._xla_layers(x, ws, bs, acts, soft),
            (fm.weights, fm.biases), (1, 2))]
    for mode in ("w8", "w8a8"):
        q = QuantizedMLP.from_fused(fm, mode)
        out.append((f"QuantizedMLP.run {mode}",
                    lambda x, qs, ss, bs, mode=mode: fast._q_layers(
                        x, qs, ss, bs, acts, soft, mode),
                    (q._padded(), q.scales, q.biases), (1, 2, 3)))
    return out


def turns(arms: dict) -> dict:
    ts = {a: [] for a in arms}
    names = list(arms)
    gc.collect()
    for t in range(TURNS):
        for a in (names if t % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                arms[a]()
            torch.cuda.synchronize()
            ts[a].append((time.perf_counter() - t0) / CALLS * 1e6)
    return {a: statistics.median(v) for a, v in ts.items()}


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in engine.flatten(tree))


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    flag = model(FLAGSHIP, ("logistic", "logistic", "identity"), 0)
    stack = model((STACK_N,) * (STACK_L + 1), ("relu",) * STACK_L, 1)
    r = torch.Generator(device="cuda").manual_seed(0)
    for label, fm, buckets in (("flagship", flag, (8, 64)),
                               ("4x4096 stack", stack, (8,))):
        width = fm.weights[0].shape[1]
        for name, fn, weights, in_place in forwards(fm):
            copy = engine.jit(fn, f"{name}, weights copied")
            held = engine.jit(fn, f"{name}, weights in place", in_place)
            for b in buckets:
                x = torch.rand(b, width, device="cuda", generator=r)
                arms = {"direct": lambda: fn(x, *weights),
                        "graph, weights copied": lambda: copy(x, *weights),
                        "graph, weights in place": lambda: held(x, *weights)}
                with torch.inference_mode():
                    want = fn(x, *weights)   # the function itself: direct
                    for a in ("graph, weights copied",
                              "graph, weights in place"):
                        for _ in range(2):   # the capture, then a replay
                            got = arms[a]()
                            assert torch.equal(got, want), (label, name, b, a)
                    wall = turns(arms)
                print(f"{label} {name} B={b}: "
                      + "; ".join(f"{a} {us:.1f} us" for a, us in
                                  wall.items())
                      + f" (graphs bit-equal to the direct call)", flush=True)
            print(f"{label} {name}: static bytes of the graphs, weights "
                  f"copied {copy.static_bytes()}, in place "
                  f"{held.static_bytes()}; the weights {nbytes(weights)}",
                  flush=True)


if __name__ == "__main__":
    main()
