#!/usr/bin/env python3
"""Time ``fused_linear_w8`` (kernel 4) of an older checkout in turns with this
checkout's, on one NVIDIA GPU.

    python3 tools/w8_before_after.py OLD_CHECKOUT

OLD_CHECKOUT is the root of a checkout whose ``csrc/fused_linear_w8.cu``
still has the C entry of the design before ``w8_plan`` (32 output columns a
block over a row tile: ``fused_linear_w8_f32(x, wq, scale, b, y, B, K, Kp, O,
rows, act, highest, stream)``, rows from ``int8_tile_rows(B, Kp, 4)``), for
example a ``git archive`` of the commit before the redesign.  Its source is
built with this checkout's nvcc flags into ``build/kernels/old/``.  Both are
timed at the flagship's three layers (784->300->100->10, logistic, logistic,
identity, "default") at B = 8, 64 and 512, on the same random int8 weights
(seed 0): the profiler's device time per layer and the CUDA-event median,
old, new, new, old, and each new result is held to the old one's within
1e-4 + 1e-5|old| (the two sum in another order).  Prints one line per
layer and batch, the card's name and power limit first.
"""

from __future__ import annotations

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
    src = os.path.join(root, "tensor_ops_tpu_torch", "csrc", "fused_linear_w8.cu")
    out = cuda_build.BUILD_DIR / "old"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "fused_linear_w8_old.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                    src], check=True, capture_output=True, text=True)
    fn = ctypes.PyDLL(str(so)).fused_linear_w8_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    old = build_old(argv[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(0)
    layers = []
    for k, o in zip(C.FLAGSHIP[:-1], C.FLAGSHIP[1:]):
        w = torch.as_tensor(r.normal(size=(o, k)) / math.sqrt(k),
                            dtype=torch.float32)
        q, s = K.quantize_weights_int8(w)
        layers.append((K.pad_codes(q).to(C.DEVICE), s.reshape(-1).to(C.DEVICE),
                       torch.as_tensor(r.normal(size=o) * 0.3,
                                       dtype=torch.float32, device=C.DEVICE)))
    for B in C.W8_TIMED_BATCHES:
        h = torch.as_tensor(r.uniform(size=(B, C.FLAGSHIP[0])),
                            dtype=torch.float32, device=C.DEVICE)
        sums = [0.0] * 4
        for i, ((q, s, b), a) in enumerate(zip(layers, C.FLAGSHIP_INT8_ACTS)):
            k, o = C.FLAGSHIP[i], C.FLAGSHIP[i + 1]
            y_old = torch.empty(B, o, device=C.DEVICE)

            def before():
                err = old(h.data_ptr(), q.data_ptr(), s.data_ptr(),
                          b.data_ptr(), y_old.data_ptr(), B, k, q.shape[1], o,
                          K.int8_tile_rows(B, q.shape[1], 4), K.ACT_CODES[a],
                          0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"old fused_linear_w8: cudaError_t {err}")
                return y_old

            def after():
                return K._fused_linear_w8_cuda(h, q, s, b, a, "default")

            C.max_err(after(), before(), C.TOL_Z)
            torch.cuda.synchronize()
            runs = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                fn = before if name == "old" else after
                runs[name].append((C._profile_steps(fn)["busy_us"],
                                   C._median_ms(fn)))
            od, nd = (statistics.median(u for u, _ in runs[n]) for n in ("old", "new"))
            oe, ne = (statistics.median(m for _, m in runs[n]) for n in ("old", "new"))
            for j, v in enumerate((od, nd, oe, ne)):
                sums[j] += v
            print(f"fused_linear_w8 B={B} {k}->{o} {a}: device old "
                  f"{', '.join(f'{u:.2f}' for u, _ in runs['old'])} us, new "
                  f"{', '.join(f'{u:.2f}' for u, _ in runs['new'])} us; events "
                  f"old {oe:.4f} ms, new {ne:.4f} ms "
                  f"(new plan {K.w8_plan(B, k, o).instance} grid "
                  f"{K.w8_plan(B, k, o).grid})", flush=True)
            h = after()
        print(f"fused_linear_w8 B={B} three layers: device old {sums[0]:.2f} "
              f"us, new {sums[1]:.2f} us; events old {sums[2]:.4f} ms, new "
              f"{sums[3]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
