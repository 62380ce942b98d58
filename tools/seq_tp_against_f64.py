#!/usr/bin/env python3
"""``fit_sequences`` with the Elman cell split over the model axis against
one device and against CPU f64, on one NVIDIA GPU.

    python3 tools/seq_tp_against_f64.py

Both legs of phase 24 of ``chip_smoke.py`` (adam, then the dual-rate
sgd): the recurrent model (32 -> [512] -> 32, seed 7) for 4 steps of 256
sequences of 64 steps (standard normal, seed 0) on a ``(2, 2)`` mesh of
the card (the split, ``parallel/tp_seq.py``) and on the card alone, both
in f32 with TF32 off, and the same loop on the CPU in f64 from the same
leaves.  For each leg and leaf the largest distance split - one device,
split - f64 and one device - f64, and the three loss curves: whether the
split is as far from f64 as the one-device scan is.  The card's name and
power limit first; each f64 run takes a minute or two of the host's CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from tensor_ops_tpu_torch import TorchBackend  # noqa: E402
from tensor_ops_tpu_torch.models import (adam, fit_sequences,  # noqa: E402
                                         squared_error)
from tensor_ops_tpu_torch.models.recurrent import (  # noqa: E402
    RecurrentNetwork)

LEAVES = ("s0", "wS", "wX", "b", "w_out", "b_out")


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    warnings.simplefilter("ignore")
    torch.backends.cuda.matmul.allow_tf32 = False
    be = TorchBackend(torch.float32, C.DEVICE)
    net = C.rnn_model(be)
    r = np.random.default_rng(0)
    n = C.MESH_SEQ_STEPS * C.SEQ_FIT_BATCH
    XS = r.standard_normal((n, C.RNN_N, C.RNN_IN)).astype(np.float32)
    TS = r.standard_normal((n, C.RNN_N, C.RNN_OUT)).astype(np.float32)
    loss = squared_error(C.RNN_OUT)
    cpu = TorchBackend(torch.float64, "cpu")
    net64 = RecurrentNetwork(
        net.op, tuple(s.double().cpu() for s in net.states),
        tuple(p.double().cpu() for p in net.params), net.arch)

    def leaves(res):
        return [C._whole(x).double().cpu()
                for x in tuple(res.net.states) + tuple(res.net.params)]

    for leg, opt in (("adam", adam()), ("dual-rate sgd", None)):
        kw = dict(epochs=1, batch_size=C.SEQ_FIT_BATCH, log_every=1,
                  verbose=False, chain_steps=1, optimizer=opt,
                  **C.SEQ_FIT_RATES)
        split = fit_sequences(net, loss, be, XS, TS,
                              mesh=C._tp_mesh((2, 2)), **kw)
        single = fit_sequences(net, loss, be, XS, TS, **kw)
        t0 = time.perf_counter()
        f64 = fit_sequences(net64, loss, cpu, XS.astype(np.float64),
                            TS.astype(np.float64), **kw)
        print(f"[{leg}] the f64 run on the CPU: "
              f"{time.perf_counter() - t0:.1f} s")
        for name, a, b, c in zip(LEAVES, leaves(split), leaves(single),
                                 leaves(f64)):
            print(f"[{leg}] {name}: split - one device "
                  f"{float((a - b).abs().max()):.3e}, split - f64 "
                  f"{float((a - c).abs().max()):.3e}, one device - f64 "
                  f"{float((b - c).abs().max()):.3e}, max |f64| "
                  f"{float(c.abs().max()):.3f}")
        for name, res in (("split", split), ("one device", single),
                          ("f64", f64)):
            print(f"[{leg}] losses, {name}: "
                  f"{[h['loss'] for h in res.history]}", flush=True)


if __name__ == "__main__":
    main()
