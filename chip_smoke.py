#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises, and the script then exits non-zero
without printing a result line:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions.  Exits non-zero when CUDA is not available.
2. Build: compiles the hand-written kernels from ``tensor_ops_tpu_torch/
   csrc/`` with ``nvcc`` (``sm_90a``) and prints ptxas' resource report.
3. Kernels: each kernel against its plain PyTorch version on the same
   inputs, TF32 off, ``torch.cuda.synchronize()`` after every launch.
4. Slice: the flagship MNIST MLP 784-300-100-10 (random weights, seed 0) is
   saved with ``save_network`` and served through the serve app
   (``tensor_ops_tpu_torch.apps.serve.main``) and through a per-layer
   ``Predictor``; the served probabilities are held against the port's IR
   forward on the card and a CPU float64 run of the same checkpoint.  Every
   kernel must have been launched by this phase.
5. Timing: p50 serving latency per bucket, and each kernel's time beside
   its plain version's (median of 50 CUDA-event-timed runs after warm-up).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = (784, 300, 100, 10)
FLAGSHIP_ACTS = ("logistic", "logistic", "softmax")
BUCKETS = (8, 64, 512)
TIMED_RUNS = 50
DEVICE = "cuda"
# f32 sums of up to 784 products, added in another order than cuBLAS adds
# them: pre-activations reach |z| ~ 30 and differ by up to ~3e-5, so they
# (and the activations of one layer, whose slope is at most 1) are held to
# absolute 1e-4 plus relative 1e-5; the probabilities a softmax makes of
# the flagship's small logits are held to 1e-5.
TOL_Z = (1e-4, 1e-5)
TOL_P = (1e-5, 0.0)

KERNELS = {
    "fused_linear": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_linear.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:101"),
    "fused_mlp_forward": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_mlp_forward.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:288"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """Max |got - want|, after checking every element against
    ``atol + rtol * |want|``."""
    got, want = got.double().cpu(), want.double().cpu()
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite output")
    diff = (got - want).abs()
    atol, rtol = tol
    check(bool((diff <= atol + rtol * want.abs()).all()),
          f"max |err| {diff.max().item():.3e} beyond atol {atol} rtol {rtol}")
    return float(diff.max()) if diff.numel() else 0.0


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from tensor_ops_tpu_torch.ops import cuda_build

    for name, k in KERNELS.items():
        built = cuda_build.build(name)
        log(f"[build] {k['source']} -> {built.path.name} in "
            f"{built.seconds:.1f} s")
        for line in built.log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"[build]   {line.strip()}")


def _rand(seed: int, *shape, scale: float = 1.0, uniform: bool = False):
    r = np.random.default_rng(seed)
    a = r.uniform(0, 1, size=shape) if uniform else r.normal(size=shape)
    return torch.as_tensor((a * scale).astype(np.float32), device=DEVICE)


def phase_kernels() -> dict:
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = {name: 0.0 for name in KERNELS}
    shapes = [(B, FLAGSHIP[i], FLAGSHIP[i + 1])
              for B in (1, 8, 63, 512) for i in range(3)]
    shapes += [(7, 13, 5), (33, 40, 10)]
    for n, (B, Kd, O) in enumerate(shapes):
        x = _rand(10 + n, B, Kd, uniform=True)
        w = _rand(20 + n, O, Kd, scale=0.5)
        b = _rand(30 + n, O, scale=0.5)
        errs = []
        for act in ("identity", "logistic", "relu", "tanh"):
            for save_z in (False, True):
                y, z = K._fused_linear_cuda(x, w, b, act, save_z)
                torch.cuda.synchronize()
                y_ref, z_ref = K.fused_linear_ref(x, w, b, act, save_z=True)
                e = max_err(y, y_ref, TOL_Z)
                if save_z:
                    e = max(e, max_err(z, z_ref, TOL_Z))
                errs.append(f"{act}{'+z' if save_z else ''} {e:.1e}")
                worst["fused_linear"] = max(worst["fused_linear"], e)
        log(f"[kernel] fused_linear B={B} {Kd}->{O} max|err| "
            f"{', '.join(errs)}; tol {TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|")

    nets = [(FLAGSHIP, ("logistic", "logistic", "identity"), B, sm)
            for B in (1, 8, 63) for sm in (True, False)]
    nets += [((33, 20, 7), ("tanh", "relu"), 37, False),
             ((33, 20, 7), ("relu", "identity"), 37, True)]
    for n, (dims, acts, B, sm) in enumerate(nets):
        x = _rand(40 + n, B, dims[0], uniform=True)
        ws = [_rand(50 + 10 * n + i, dims[i + 1], dims[i], scale=0.5)
              for i in range(len(dims) - 1)]
        bs = [_rand(60 + 10 * n + i, dims[i + 1], scale=0.5)
              for i in range(len(dims) - 1)]
        y = K._fused_mlp_forward_cuda(x, ws, bs, acts, sm)
        torch.cuda.synchronize()
        y_ref = K.fused_mlp_forward_ref(x, ws, bs, acts, sm)
        tol = TOL_P if sm else TOL_Z
        e = max_err(y, y_ref, tol)
        if sm:
            max_err(y.sum(dim=1), torch.ones(B), TOL_P)
        worst["fused_mlp_forward"] = max(worst["fused_mlp_forward"], e)
        log(f"[kernel] fused_mlp_forward B={B} {'-'.join(map(str, dims))} "
            f"softmax={int(sm)} rows/block={K.tile_rows(B, dims)} "
            f"max|err| {e:.2e} tol {tol[0]:g}+{tol[1]:g}|ref|")
    return worst


def _served_probs(stdout: str, n: int) -> np.ndarray:
    rows = [l for l in stdout.splitlines() if l and l[0].isdigit()]
    check(len(rows) == n, f"serve app printed {len(rows)} rows, want {n}")
    return np.array([[float(v) for v in r.split(",")] for r in rows])


def phase_slice(tmp: str) -> dict:
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.apps import serve as serve_app
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (FusedMLP, Predictor,
                                             activation_by_name, gen_net)
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_network,
                                                       save_network)

    def flagship(be, seed):
        hidden = [(h, activation_by_name(a))
                  for h, a in zip(FLAGSHIP[1:-1], FLAGSHIP_ACTS[:-1])]
        return gen_net(be, FLAGSHIP[0], FLAGSHIP[-1], hidden,
                       activation_by_name(FLAGSHIP_ACTS[-1]), Rng(be, seed))

    be = TorchBackend(torch.float32, DEVICE)
    net = flagship(be, 0)
    ckpt = os.path.join(tmp, "flagship.npz")
    save_network(ckpt, net)
    x = np.random.default_rng(1).uniform(0, 1, size=(5, FLAGSHIP[0]))
    x = x.astype(np.float32)
    xfile = os.path.join(tmp, "batch.npy")
    np.save(xfile, x)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ckpt, "-i", xfile, "--probs", "--device", DEVICE,
                        "--buckets", ",".join(map(str, BUCKETS))])
    served = _served_probs(buf.getvalue(), len(x))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ckpt, "--bench", "--device", DEVICE,
                        "--buckets", ",".join(map(str, BUCKETS))])
    bench = json.loads(buf.getvalue().strip().splitlines()[-1])["latency"]
    model = FusedMLP.from_network(load_network(ckpt, net, be))
    per_layer = Predictor(model, buckets=BUCKETS, use_fused_kernel=False)
    layered = per_layer.predict(x)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"[slice] served {len(x)} rows through the app, --bench over "
        f"buckets {BUCKETS} (n={bench['n']}), {len(x)} rows through the "
        f"per-layer route, in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")

    ir = torch.stack([net.run(be, be.asarray(r)) for r in x]).cpu().numpy()
    cpu64 = TorchBackend(torch.float64, "cpu")
    net64 = load_network(ckpt, flagship(cpu64, 0), cpu64)
    f64 = torch.stack([net64.run(cpu64, cpu64.asarray(r)) for r in x]).numpy()
    # the app prints 6 decimals: half a unit of the last digit on top of
    # each value, and of each of a row's 10 values in its sum
    rounding = 5e-7
    out = {"served": (served, rounding), "per_layer": (layered, 0.0)}
    for what, (got, r) in out.items():
        for ref_name, ref in (("IR on the card", ir), ("CPU f64", f64)):
            e = max_err(torch.as_tensor(got), torch.as_tensor(ref),
                        (TOL_P[0] + r, 0.0))
            log(f"[slice] {what} vs {ref_name}: max|err| {e:.2e}")
        e = max_err(torch.as_tensor(got.sum(axis=1)), torch.ones(len(x)),
                    (TOL_P[0] + FLAGSHIP[-1] * r, 0.0))
        log(f"[slice] {what} rows sum to 1: max|err| {e:.2e}")
        check(np.array_equal(got.argmax(1), f64.argmax(1)),
              f"{what}: classes differ from the CPU f64 run")
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the slice")
    return {"launches": launches, "model": model}


def _median_ms(fn) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMED_RUNS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_timing(model) -> dict:
    from tensor_ops_tpu_torch.models import Predictor
    from tensor_ops_tpu_torch.ops import kernels as K

    pred = Predictor(model, buckets=BUCKETS)
    pred.warmup()
    r = np.random.default_rng(2)
    for b in BUCKETS:
        x = r.uniform(0, 1, size=(b, FLAGSHIP[0])).astype(np.float32)
        pred.timer.samples.clear()
        for _ in range(TIMED_RUNS):
            pred.predict(x)
        route = "fused_mlp_forward" if b < pred.xla_threshold else "matmul"
        log(f"[timing] Predictor bucket {b} ({route}): p50 "
            f"{pred.latency()['p50_s'] * 1e3:.4f} ms host clock "
            f"(n={TIMED_RUNS})")

    ws = [w.float() for w in model.weights]
    bs = [b.float() for b in model.biases]
    acts = model.acts
    times = {}
    with torch.inference_mode():
        for B in (8, 512):
            x = _rand(70 + B, B, FLAGSHIP[0], uniform=True)
            hs = [x]
            for w, b, a in zip(ws, bs, acts):
                hs.append(K.fused_linear_ref(hs[-1], w, b, a))
            tk = tp = 0.0
            for i in range(3):
                h, w, b, a = hs[i], ws[i], bs[i], acts[i]
                k_ms = _median_ms(lambda: K._fused_linear_cuda(
                    h, w, b, a, False))
                p_ms = _median_ms(lambda: K.fused_linear_ref(h, w, b, a))
                tk, tp = tk + k_ms, tp + p_ms
                log(f"[timing] fused_linear B={B} {FLAGSHIP[i]}->"
                    f"{FLAGSHIP[i + 1]} {a}: kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms")
            log(f"[timing] fused_linear B={B} three flagship layers: "
                f"kernel {tk:.4f} ms, plain {tp:.4f} ms")
            if B == 8:
                times["fused_linear"] = (tk, tp)
        for B in (1, 8, 63):
            x = _rand(80 + B, B, FLAGSHIP[0], uniform=True)
            k_ms = _median_ms(lambda: K._fused_mlp_forward_cuda(
                x, ws, bs, acts, True))
            p_ms = _median_ms(lambda: K.fused_mlp_forward_ref(
                x, ws, bs, acts, True))
            log(f"[timing] fused_mlp_forward B={B} flagship: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if B == 8:
                times["fused_mlp_forward"] = (k_ms, p_ms)
    return times


def main() -> int:
    name = phase_environment()
    t0 = time.perf_counter()
    phase_build()
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")
    worst = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        sl = phase_slice(tmp)
    times = phase_timing(sl["model"])
    kernels = [dict(name=n, **KERNELS[n], launches=sl["launches"][n],
                    max_abs_err=worst[n], ms=times[n][0],
                    plain_ms=times[n][1])
               for n in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
