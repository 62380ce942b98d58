#!/usr/bin/env python3
"""Hold ``fused_mlp_train_step`` (kernel 3) of an older checkout against
this checkout's, bit for bit, on one NVIDIA GPU.

    python3 tools/train_step_before_after.py OLD_CHECKOUT

OLD_CHECKOUT is the root of a checkout whose ``csrc/fused_mlp_train_step.cu``
takes the rate by value only (``fused_mlp_train_step_f32(..., loss_kind,
float lr, scratch, ...)``), for example a ``git archive`` of the commit
before the rate could come from the card's memory.  Its source is built
in place (with its own headers) with this checkout's nvcc flags into
``build/kernels/old/``.  At the flagship (B = 100 and 1000), the
784-128-32-128-784 autoencoder (squared error, B = 100) and 33-20-7 (B =
37), on seeded inputs, the step runs in the turns old, new, new with the
rate as a 0-d tensor on the card, old; every result must equal the first
old one bit for bit.  Prints one line per case, the card's name and power
limit first; exits 1 when any differs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tensor_ops_tpu_torch.ops import cuda_build  # noqa: E402
from tensor_ops_tpu_torch.ops import kernels as K  # noqa: E402

CASES = (((784, 300, 100, 10), 100, "softmax_xent",
          ("logistic", "logistic", "identity")),
         ((784, 300, 100, 10), 1000, "softmax_xent",
          ("logistic", "logistic", "identity")),
         ((784, 128, 32, 128, 784), 100, "squared_error", ("logistic",) * 4),
         ((33, 20, 7), 37, "softmax_xent", ("tanh", "identity")))


def build_old(root: str):
    """The old C entry, bound with the old argument list."""
    out = os.path.join(cuda_build.BUILD_DIR, "old")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "fused_mlp_train_step.so")
    src = os.path.join(root, "tensor_ops_tpu_torch", "csrc",
                       "fused_mlp_train_step.cu")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           so, src], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(so).fused_mlp_train_step_f32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(root: str) -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    old_fn, new_kernel = build_old(root), K._kernel

    def old_kernel(lib, name, argtypes, keep_gil=False):
        if name != "fused_mlp_train_step_f32":
            return new_kernel(lib, name, argtypes, keep_gil)
        # the new argument list less the rate's pointer
        return lambda *a: old_fn(*(a[:12] + a[13:]))

    ok = True
    for dims, B, kind, acts in CASES:
        r = np.random.default_rng(1)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

        x = dev(r.uniform(0, 1, size=(B, dims[0])))
        y = x if kind == "squared_error" else dev(
            np.eye(dims[-1])[r.integers(0, dims[-1], B)])
        ws = [dev(r.normal(size=(dims[k + 1], dims[k])) / np.sqrt(dims[k]))
              for k in range(len(dims) - 1)]
        bs = [dev(r.normal(size=dims[k + 1]) * 0.3)
              for k in range(len(dims) - 1)]
        outs = {}
        for turn in ("old", "new", "new, rate on the card", "old again"):
            K._kernel = old_kernel if turn.startswith("old") else new_kernel
            K._bound.clear()
            rate = (torch.tensor(0.3, device="cuda") if "card" in turn
                    else 0.3)
            v, nw, nb = K.fused_mlp_train_step(x, y, ws, bs, rate, acts,
                                               loss_kind=kind)
            torch.cuda.synchronize()
            outs[turn] = [v] + nw + nb
        K._kernel = new_kernel
        K._bound.clear()
        same = {t: all(torch.equal(a, b) for a, b in zip(outs["old"], o))
                for t, o in outs.items()}
        ok &= all(same.values())
        print(f"kernel 3 {'-'.join(map(str, dims))} B={B} {kind}: bit-equal "
              f"to the old launch: {same}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
