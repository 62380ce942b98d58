#!/usr/bin/env python3
"""Dropping torch's cuBLAS workspaces around CUDA graph captures, on one
NVIDIA GPU: which drops let the smoke's phase 22 (the mixed-precision
router's captured steps) and phase 31's serving soak pass.

    python3 tools/cublas_workspace_drops.py [VARIANT ...]

A variant names the points of ``engine.capture`` at which
``torch._C._cuda_clearCublasWorkspaces()`` runs: ``w`` before the warm-up,
``c`` before the capture, ``a`` after it (``wca`` is what the port did
before it kept the workspaces; ``none``, the default, is what it does
now), with ``sync`` for a device synchronise before each drop.  Each
variant runs in an interpreter of its own: first one direct
``training.accuracy`` of the flagship on 1,000 rows (a cuBLAS call before
any capture, the engine's graphs off), then phase 22; and, in two more
interpreters, the soak arms of phase 31 (``chip_smoke.GRAPH_SOAK_ARMS``).
Prints PASS or FAIL and the first error line of each, the card's name and
power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BODY = r'''
import gc, sys, tempfile, numpy as np, torch
import chip_smoke as S
from tensor_ops_tpu_torch import TorchBackend, engine
from tensor_ops_tpu_torch.models import FusedMLP
from tensor_ops_tpu_torch.models import training as TT
variant, check = sys.argv[1], sys.argv[2]
points = "" if variant == "none" else variant.replace("sync", "")


def drop(point):
    if point in points:
        if "sync" in variant:
            torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()


def capture(fn, device, what="", remedy="", streams=None, pool=None):
    # engine.capture with the drops at the variant's points
    device = torch.device(device)
    if streams is None:
        gc.collect()
    gc.disable()
    try:
        cur = torch.cuda.current_stream(device)
        warm, on = streams if streams is not None else (
            torch.cuda.Stream(device), None)
        warm.wait_stream(cur)
        drop("w")
        with torch.cuda.stream(warm):
            fn(False)
        cur.wait_stream(warm)
        graph = torch.cuda.CUDAGraph()
        drop("c")
        kw = {} if on is None else {"stream": on}
        if pool is not None:
            kw["pool"] = pool
        with torch.cuda.graph(graph, capture_error_mode="thread_local", **kw):
            fn(True)
        drop("a")
        torch.cuda.synchronize(device)
    finally:
        gc.enable()
    return graph


engine.capture = capture
be = TorchBackend(torch.float32, "cuda")
if check == "phase22":
    engine.uses_graphs = lambda d: False
    net = S._flagship_net(be)
    X = be.asarray(np.random.default_rng(0).uniform(0, 1, (1000, 784)))
    TT.accuracy(net, be, X, np.random.default_rng(1).integers(0, 10, 1000))
    del net
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        S.phase_mixed_precision(tmp)
else:
    fm = FusedMLP.from_network(S._flagship_net(be))
    for bucket, rows in S.GRAPH_SOAK_ARMS:
        S._graph_soak(fm, bucket, rows)
print("PASSED", flush=True)
'''


def main(variants) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for variant in variants or ["none"]:
        for check in ("phase22", "soak", "soak"):
            p = subprocess.run([sys.executable, "-c", BODY, variant, check],
                               capture_output=True, text=True, timeout=300,
                               cwd=HERE, env=dict(os.environ,
                                                  PYTHONPATH=HERE))
            out = p.stdout + p.stderr
            err = next((l for l in out.splitlines() if "rror" in l), "")
            print(f"{variant} {check}: "
                  f"{'PASS' if 'PASSED' in out else 'FAIL'} (exit "
                  f"{p.returncode}) {err[:160]}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
