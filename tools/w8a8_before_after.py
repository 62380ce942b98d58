#!/usr/bin/env python3
"""Time ``fused_linear_w8a8`` (kernel 5) of an older checkout in turns with
this checkout's, on one NVIDIA GPU.

    python3 tools/w8a8_before_after.py OLD_CHECKOUT

OLD_CHECKOUT is the root of a checkout whose ``csrc/fused_linear_w8a8.cu``
still has the C entry of the design before ``w8a8_plan`` (a quantizing
launch, then a ``__dp4a`` product over row tiles:
``fused_linear_w8a8_f32(x, wq, sw, b, y, xq, sx, B, K, Kp, O, rows, act,
stream)``, rows from ``int8_tile_rows(B, Kp, 1)``), for example a ``git
archive`` of the commit before the redesign.  Its source is built with this
checkout's nvcc flags into ``build/kernels/old/``.  Both are timed at the
flagship's three layers (784->300->100->10, logistic, logistic, identity) at
B = 8, 64 and 512 and at one 4096 x 4096 relu layer at B = 16 and 64, on the
same random int8 weights (seed 0), beside this checkout's kernel forced to
its other instance where that takes the batch (at B = 8: the quantizer and
the product under programmatic dependent launch, or the one launch, through
the same wrapper, ``chip_smoke.w8a8_instance``): device time per call in a
CUDA graph (``chip_smoke._graph_us``), the profiler's kernel time and the
CUDA-event median, in the order old, new, other, other, new, old.  Each new
result is held to the old one bit for bit (both sum int32 exactly and share
the epilogue).  Prints one line per layer and batch, the card's name and
power limit first.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from tensor_ops_tpu_torch.ops import cuda_build  # noqa: E402
from tensor_ops_tpu_torch.ops import kernels as K  # noqa: E402


def build_old(root: str):
    src = os.path.join(root, "tensor_ops_tpu_torch", "csrc",
                       "fused_linear_w8a8.cu")
    out = cuda_build.BUILD_DIR / "old"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "fused_linear_w8a8_old.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                    src], check=True, capture_output=True, text=True)
    fn = ctypes.PyDLL(str(so)).fused_linear_w8a8_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def layers(r):
    """The flagship's three layers and one 4096-wide layer: (codes padded,
    scales, biases, act) on the card."""
    out = []
    for k, o, a in zip(C.FLAGSHIP[:-1] + (4096,), C.FLAGSHIP[1:] + (4096,),
                       C.FLAGSHIP_INT8_ACTS + ("relu",)):
        w = torch.as_tensor(r.normal(size=(o, k)) / math.sqrt(k),
                            dtype=torch.float32)
        q, s = K.quantize_weights_int8(w)
        out.append((K.pad_codes(q).contiguous().to(C.DEVICE),
                    s.reshape(-1).to(C.DEVICE),
                    torch.as_tensor(r.normal(size=o) * 0.3, dtype=torch.float32,
                                    device=C.DEVICE), a))
    return out


def report(graph, med, label) -> str:
    """One line of times: device per call in a CUDA graph (each turn's),
    the profiler's busy time and the CUDA-event median, per design."""
    return ("device per call (CUDA graph) " + ", ".join(
        f"{label[n]} {', '.join(f'{g:.2f}' for g in graph[n])}"
        for n in graph) + " us; profiler busy " + ", ".join(
        f"{n} {med[n][1]:.2f}" for n in med) + " us; events " + ", ".join(
        f"{n} {med[n][2]:.4f}" for n in med) + " ms")


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    old = build_old(argv[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    r = np.random.default_rng(0)
    ls = layers(r)
    dev = torch.cuda.current_device()
    cases = [(B, ls[:3]) for B in C.W8A8_TIMED[0]] + [
        (B, ls[3:]) for B in C.W8A8_TIMED[1]]
    for B, group in cases:
        k0 = C.FLAGSHIP[0] if len(group) == 3 else 4096
        h = torch.as_tensor(r.uniform(-1, 1, size=(B, k0)),
                            dtype=torch.float32, device=C.DEVICE)
        sums = {}
        for q, s, b, a in group:
            k, o, kp = h.shape[1], q.shape[0], q.shape[1]
            y_old = torch.empty(B, o, device=C.DEVICE)
            xq = torch.empty(B, kp, dtype=torch.int8, device=C.DEVICE)
            sx = torch.empty(B, device=C.DEVICE)
            plan = K.w8a8_plan(B, k, o, K._sm_count(dev))
            other = None  # the other instance, where it takes B rows
            if B <= K.W8A8_ROWS[0]:
                other = K.w8a8_plan(B, k, o, K._sm_count(dev), instance=(
                    "fused" if plan.instance == "pdl" else "pdl"))
            names = ("old", "new", "other") if other else ("old", "new")
            xf = h.contiguous()

            def before():
                err = old(xf.data_ptr(), q.data_ptr(), s.data_ptr(),
                          b.data_ptr(), y_old.data_ptr(), xq.data_ptr(),
                          sx.data_ptr(), B, k, kp, o,
                          K.int8_tile_rows(B, kp, 1), K.ACT_CODES[a],
                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"old fused_linear_w8a8: cudaError_t "
                                       f"{err}")
                return y_old

            def after():
                return K._fused_linear_w8a8_cuda(xf, q, s, b, a)

            def forced(name):
                """``name``'s instance: "other" runs the same wrapper with
                the other instance forced."""
                return (C.w8a8_instance(other.instance) if name == "other"
                        else contextlib.nullcontext())

            want = before().clone()
            for name in names[1:]:
                with forced(name):
                    got = after()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"B={B} {k}->{o}: {name} is not "
                                     f"bit-equal to the old kernel")
            runs = {n: [] for n in names}
            for name in names + names[::-1]:
                f = before if name == "old" else after
                with forced(name):
                    runs[name].append((C._graph_us(f),
                                       C._profile_steps(f)["busy_us"],
                                       C._median_ms(f)))
            med = {n: [statistics.median(v[j] for v in runs[n])
                       for j in range(3)] for n in runs}
            for n in med:
                sums[n] = [x + y for x, y in zip(sums.get(n, [0.0] * 3),
                                                  med[n])]
            label = {"old": "old", "new": f"new ({plan.instance} grid "
                     f"{plan.grid})"}
            if other:
                label["other"] = f"other ({other.instance} grid {other.grid})"
            print(f"fused_linear_w8a8 B={B} {k}->{o} {a}: " + report(
                {n: [g for g, _, _ in runs[n]] for n in names},
                med, label), flush=True)
            h = after().clone()
        print(f"fused_linear_w8a8 B={B}, {len(group)} layer(s): " + report(
            {n: [sums[n][0]] for n in sums}, sums, {n: n for n in sums}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
