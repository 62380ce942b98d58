#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises, and the script then exits non-zero
without printing a result line:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions.  Exits non-zero when CUDA is not available.
2. Build: compiles the hand-written kernels from ``tensor_ops_tpu_torch/
   csrc/`` with ``nvcc`` (``sm_90a``), one compiler per source, all at
   once, and prints ptxas' resource report.
3. Kernels: each kernel against its plain PyTorch version on the same
   inputs, TF32 off, ``torch.cuda.synchronize()`` after every launch.
   ``fused_linear``: every instance of ``linear_plan`` (gemv, tile with K
   split over blocks, large) at the flagship's layers for B = 1 to 512,
   K = 13 and 783 (scalar loads) and 4096^3, every activation with and
   without z, each shape rerun bit for bit, and with bf16 operands (y to
   one bf16 ulp of the plain y, z to 1e-4 + 1e-5|z|, each launch counted,
   the backward's dtypes those of the JAX VJP).  The train step at B = 1
   to 1000 and both loss kinds, and twice on one input, bit for bit.
4. Serving slice: the flagship MNIST MLP 784-300-100-10 (random weights,
   seed 0) is saved with ``save_network`` and served through the serve app
   (``tensor_ops_tpu_torch.apps.serve.main``) and through a per-layer
   ``Predictor``; the served probabilities are held against the port's IR
   forward on the card and a CPU float64 run of the same checkpoint.  Both
   serving kernels must have been launched by this phase.
5. Training slice: the mnist app (``tensor_ops_tpu_torch.apps.mnist.main``)
   trains the flagship for one epoch of the synthetic set (6,000 rows,
   batches of 1,000) through ``--minibatch 100 --fused`` (the train-step
   kernel must have been launched) and through ``--minibatch 100``; the
   training error must fall in both.  Then 5 steps of ``train_fullfused``
   on the card are held against ``FusedMLP.train`` on the card and the
   plain step in CPU float64.
6. int8 kernels: ``fused_linear_w8`` at the flagship's three layers (B = 1,
   8, 37, both precisions), ``fused_linear_w8a8`` at the same shapes, a
   misaligned 257-wide case and an int32-exact case, and
   ``fused_mlp_w8a8_forward`` at the uniform serving stack (4 x 4096, seed
   0, B = 16 and 5), each against its plain version; the whole-MLP kernel
   bit for bit against the per-layer CUDA chain and (relu) its plain
   version.
7. int8 serving slice: the serve app serves the phase-4 checkpoint with
   ``--int8`` (3 ``fused_linear_w8a8`` launches per request), a ``mode="w8"``
   ``quantized_mlp`` checkpoint of it (``fused_linear_w8``), and the 4 x 4096
   stack saved with ``save_quantized`` (``fused_mlp_w8a8_forward``); each
   is held against the plain ``QuantizedMLP`` on the CPU, and the int8
   classes against the f32 ones.
8. Recurrent kernel: ``fused_rnn_step`` against its plain version at the
   recurrent slice's shapes (B = 1 and 256, 32 -> 512) and ragged ones (B =
   37 and 5, 3 -> 45), every activation, bit for bit on a rerun, and the
   gradients of its ``autograd.Function`` against autograd through the
   plain version.
9. Recurrent slice: the Elman 32 -> [512] -> 32 model of
   ``scratch/fit_seq_realized.py`` (random weights, seed 7) is saved with
   ``save_recurrent`` and 8 sequences of 64 steps are served through the
   serve app (``--probs`` trajectories, then ``--bench --seq-len 64``),
   held against the port's ``SequencePredictor`` on the CPU in float64;
   ``FusedRNN(impl="pallas")`` built from the served model's cell runs the
   8 sequences, one ``fused_rnn_step`` launch per timestep, and the served
   trajectories are rebuilt from its outputs; five ``FusedRNN.train``
   steps on the two impls and in CPU float64 agree; the sequence gradient
   is bit-identical with and without ``offload_tape``.
10. Collectives (kernels 8-9): the one-shot, through ``ring_all_reduce``
   (one-way) and ``ring_all_reduce_bidir`` / ``ring_reduce_scatter`` /
   ``ring_all_gather``, against ``oneshot_ref`` and the ring protocol's
   plain version at R = 2, 3, 4 and 8 ranks on one card, int32 and f32
   N(0, 1), on the JAX tests' shapes and the flagship's six parameter
   shapes, f32 ar and rs also with the 1/R scale, bit for bit; the ring
   protocol (``_ring_cuda``, the route of ranks on several cards) called
   directly against its plain version at R = 2, 4 and 8; two protocol calls
   back to back on one scratch; rs then ag against ar on both routes; and,
   in a second interpreter with a time limit, the refusal of more ranks
   than one launch takes (both routes) and of a cooperative grid larger
   than the card holds.  With two or more cards, the wrappers at one rank
   per card against the plain versions; otherwise one line says it was not
   run.
11. Data-parallel slice: the flagship (random weights, seed 0, as
   ``gen_net`` draws them) for 5 steps of ``dp_megakernel_train_step`` at 4
   ranks x 100 rows of the synthetic set, on the bidirectional and the
   one-way ring: ranks bit-identical after every step, step 1 against one
   ``fused_mlp_train_step`` on the 400-row batch, 5 steps against the plain
   dp step in CPU float64, the loss falls, and 4 train-step and 6 one-shot
   launches per step (the 1/n inside them; no ring-protocol launch).
12. Timing: p50 serving latency per bucket, each kernel's time beside its
   plain version's (median of 50 CUDA-event-timed runs after warm-up), the
   profiler's device time of the kernels, where one training step's, one
   int8 request's and one recurrent request's time goes on each route
   (wall, kernels, device busy), the device memory each served model holds
   (f32 vs int8), the app's training samples/s per route, a FusedRNN
   sequence's wall time and launches, kernel 1's device time and event
   median against ``torch.addmm``'s in turns over 3 repetitions beside its
   bound at the identity layer, 784->300 at B = 8, the three flagship
   layers at B = 100 and 4096^3, kernel 3 at B = 100, 400 and 1000 with
   its grid and barrier count, each collective phase at the flagship's
   300x784 weight on 4 ranks (the one-shot in turns with one PyTorch call
   over 3 repetitions, its plain version, its device time against the
   bound; the ring protocol beside it), and a dp step's wall time, profile
   (14 kernels, 6 one-shot launches) and samples/s on each route beside a
   single-rank ``train_fullfused`` step on the same 400 rows.

The second-to-last line is ``{"kernels": [...]}``: per kernel its launches
on its main path, its largest difference from its plain version, its time
and its plain version's, its bound (the larger of the bytes it must move
over 3.35 TB/s and its operations over the peak rate of their type) and
the time of one PyTorch call computing the same function (``torch.addmm``
for ``fused_linear``, timed at an identity layer; ``torch.stack(xs).sum(0)``
for the collectives' all-reduce; null where no one call does).  Kernels 8
and 9 appear twice: under their names the one-shot, the one-card route the
dp slice runs; as ``NAME.ring`` the ring protocol, the route of ranks on
several cards, whose launches on the one-card path are 0 and whose times
come from calling it directly.  The last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
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
    "fused_mlp_train_step": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_mlp_train_step.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:385"),
    "fused_linear_w8": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_linear_w8.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:622"),
    "fused_linear_w8a8": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_linear_w8a8.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:725"),
    "fused_mlp_w8a8_forward": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_mlp_w8a8_forward.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:823"),
    "fused_rnn_step": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_rnn_step.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:959"),
    # kernels 8-9 on one card: the one-shot (csrc/oneshot.cuh) under the
    # libraries' names; across cards, the ring protocol (csrc/ring.cuh), its
    # launches counted apart as NAME.ring
    "ring_all_reduce": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/oneshot.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:46"),
    "bidir_ring": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/oneshot.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:143"),
    "ring_all_reduce.ring": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/ring.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:46"),
    "bidir_ring.ring": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/ring.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:143"),
}
# the kernel libraries: csrc/<lib>.cu, one nvcc each
LIBS = tuple(dict.fromkeys(name.split(".")[0] for name in KERNELS))
RING_NAMES = ("ring_all_reduce", "bidir_ring", "ring_all_reduce.ring",
              "bidir_ring.ring")
SERVE_KERNELS = ("fused_linear", "fused_mlp_forward")
# The uniform int8 serving stack of examples/bench_int8_serving.py:32-46 and
# bench.py:297-321: 4 layers of 4096 x 4096, ReLU, batch 16.
STACK_N, STACK_L, STACK_B = 4096, 4, 16
STACK_ACTS = ("relu", "relu", "relu", "identity")
FLAGSHIP_INT8_ACTS = ("logistic", "logistic", "identity")
# The H100 SXM's published peaks (NVIDIA's data sheet, dense): the bound of
# a kernel is the larger of its bytes over HBM_BPS and its operations over
# the peak of their type.
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
# A logistic or tanh epilogue against its plain version: expf/tanhf in the
# kernel and torch's on the card may differ by a few ulps of values <= 1.
TOL_ACT = (1e-6, 0.0)
# The train step against its plain version: the forward's 784-long sums,
# the gradient's sums over up to 1,000 rows and the update w - lr*g are
# taken in another order than cuBLAS takes them, so each value differs by a
# few f32 ulps of the terms it sums.  The mean loss is held to 1e-6 plus
# 1e-5 of itself (the squared-error losses reach ~80); new weights and
# biases to 1e-5 plus 1e-5 of themselves (weights reach ~3, where one ulp
# is 2.4e-7, and the squared-error gradients are 100x the softmax ones).
TOL_LOSS = (1e-6, 1e-5)
TOL_PARAM = (1e-5, 1e-5)
# Five SGD steps from one start: each step adds its own rounding, and the
# next step's forward and gradient carry the earlier steps' differences on,
# so the bound is five times one step's (5 x TOL_PARAM); against the f64
# plain step the f32 run's own rounding of the parameters adds to that.
TOL_5_STEPS = (5e-5, 5e-5)
TRAIN_RATE = 0.3
# The recurrent model the repo measures (scratch/fit_seq_realized.py:14-18,
# 38-47; BENCH.md:665): Elman 32 -> [512, logistic output and state] -> 32
# logistic, seed 7, sequences of 64 steps, batch 256.  8 sequences are
# served through the app; the SequencePredictor is timed at buckets 8 and
# 256.
RNN_IN, RNN_HIDDEN, RNN_OUT, RNN_N, RNN_SEED = 32, 512, 32, 64, 7
RNN_SEQS, RNN_BUCKETS = 8, (8, 256)
RNN_STEP_SHAPES = ((1, RNN_IN, RNN_HIDDEN), (256, RNN_IN, RNN_HIDDEN),
                   (37, 3, 45), (5, 3, 45))
ACTS = ("identity", "logistic", "relu", "tanh")
# The step kernel against its plain version: y = z, a 544-long f32 sum in
# another order, is held as the pre-activations above (TOL_Z); s' = act(z)
# to 1e-5 (weights at 1/sqrt(K) scale keep |z| of order 1, where the sums
# differ by ~1e-6 and act has slope <= 1).  Gradients sum over up to 512
# products or 256 rows in another order: 1e-4 + 1e-5 of themselves.
TOL_RNN_S = (1e-5, 0.0)
TOL_RNN_GRAD = (1e-4, 1e-5)
# FusedRNN.train is held over the first 8 steps of a sequence: over all 64
# this random N(0, 0.5) cell of width 512 is chaotic (a parameter step that
# small still raises the sequence loss, and f32 gradients drift from f64's),
# so no f32 run can match f64 there; over 8 steps SGD at this rate lowers
# the loss and the gradients are well-conditioned.
RNN_TRAIN_N, RNN_TRAIN_RATE = 8, 1e-6
# The data-parallel slice: the flagship over DP_RANKS ranks of DP_ROWS rows
# each (global batch 400), DP_STEPS steps of dp_megakernel_train_step.  The
# one-shot is held against its plain version at RING_RANKS ranks, and the
# ring protocol, called directly, against its own at PROTOCOL_RANKS, on the
# JAX tests' shapes (per rank; the leading axis a multiple of R, so that the
# reduce-scatter splits it) and the flagship's six parameter shapes.
DP_RANKS, DP_ROWS, DP_STEPS = 4, 100, 5
RING_RANKS = (2, 3, 4, 8)
PROTOCOL_RANKS = (2, 4, 8)
# kernels per dp step: 4 train-step launches, 6 collectives, and the
# loss's 3 adds and 1/n
DP_KERNELS_PER_STEP = 4 + 6 + 4
# bf16 fused_linear against its plain version: the f32 pre-activation is
# held to TOL_Z; y = act(z) rounded to bf16 to one bf16 ulp of the plain
# y beyond what z's tolerance carries through act (slope <= 1), since the
# two z's, a few f32 ulps apart, may round to neighbouring bf16 values.
BF16_ULP = 2.0 ** -7
# kernel 1 against its plain version: the flagship's layers at the serving
# buckets, the gemv's edge (16) and the tile's first batch (17), the
# training minibatch (100), and ragged shapes: K = 13 and K = 783 take the
# scalar loads of the gemv and of the tile
LINEAR_SHAPES = tuple((B, FLAGSHIP[i], FLAGSHIP[i + 1])
                      for B in (1, 8, 16, 17, 63, 100, 512)
                      for i in range(3)) + ((7, 13, 5), (33, 40, 10),
                                            (100, 783, 300))
FLAGSHIP_PARAM_SHAPES = tuple(
    s for k in range(3) for s in ((FLAGSHIP[k + 1], FLAGSHIP[k]),
                                  (FLAGSHIP[k + 1],)))
RING_PHASES = ("one-way ar", "ar", "rs", "ag")


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


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


def phase_build() -> None:
    from tensor_ops_tpu_torch.ops import cuda_build

    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        builds = dict(zip(LIBS, pool.map(cuda_build.build, LIBS)))
    for name in LIBS:
        built = builds[name]
        log(f"[build] tensor_ops_tpu_torch/csrc/{name}.cu -> "
            f"{built.path.name} in {built.seconds:.1f} s")
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
    held = {}  # instance -> shapes held
    for n, (B, Kd, O) in enumerate(LINEAR_SHAPES):
        x = _rand(10 + n, B, Kd, uniform=True)
        w = _rand(20 + n, O, Kd, scale=0.5)
        b = _rand(30 + n, O, scale=0.5)
        errs = []
        for act in ACTS:
            for save_z in (False, True):
                y, z = K._fused_linear_cuda(x, w, b, act, save_z)
                torch.cuda.synchronize()
                y_ref, z_ref = K.fused_linear_ref(x, w, b, act, save_z=True)
                e = max_err(y, y_ref, TOL_Z)
                if save_z:
                    e = max(e, max_err(z, z_ref, TOL_Z))
                errs.append(f"{act}{'+z' if save_z else ''} {e:.1e}")
                worst["fused_linear"] = max(worst["fused_linear"], e)
        # the instance repeats bit for bit (a split's partials are added in
        # split order whichever block adds them)
        y2, z2 = K._fused_linear_cuda(x, w, b, "tanh", True)
        torch.cuda.synchronize()
        check(torch.equal(y2, y) and torch.equal(z2, z),
              f"fused_linear B={B} {Kd}->{O}: a rerun differs")
        p = K.linear_plan(B, Kd, O)
        held.setdefault(p.instance, []).append(f"{B}x{Kd}->{O}")
        log(f"[kernel] fused_linear B={B} {Kd}->{O} instance {p.instance} "
            f"({'16-byte' if p.vec else 'scalar'} loads, grid {p.grid}, "
            f"split {p.split}) max|err| {', '.join(errs)}; tol "
            f"{TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|; rerun bit-equal")
    big = big_linear_inputs()
    y = K._fused_linear_cuda(*big, "identity", False)[0]
    y2 = K._fused_linear_cuda(*big, "identity", False)[0]
    torch.cuda.synchronize()
    e = max_err(y, K.fused_linear_ref(*big), TOL_Z)
    check(torch.equal(y, y2), "fused_linear 4096^3: a rerun differs")
    worst["fused_linear"] = max(worst["fused_linear"], e)
    held.setdefault(K.linear_plan(4096, 4096, 4096).instance, []).append(
        "4096^3")
    log(f"[kernel] fused_linear 4096^3 identity instance "
        f"{K.linear_plan(4096, 4096, 4096).instance} max|err| {e:.1e} vs "
        f"the plain version; rerun bit-equal")
    check(set(held) == set(K.LINEAR_INSTANCES),
          f"fused_linear instances held: {sorted(held)}")
    log("[kernel] fused_linear instances held: " + "; ".join(
        f"{i}: {', '.join(v)}" for i, v in sorted(held.items())))
    worst["fused_linear"] = max(worst["fused_linear"], phase_linear_bf16())

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

    steps = [((12, 8, 6, 4), ("logistic", "logistic", "identity"), 16,
              "softmax_xent")]
    steps += [(FLAGSHIP, ("logistic", "logistic", "identity"), B,
               "softmax_xent") for B in (1, 37, 100, 400, 1000)]
    steps += [((8, 3, 8), ("logistic", "logistic"), 37, "squared_error"),
              ((784, 300, 784), ("tanh", "logistic"), 37, "squared_error")]
    for n, (dims, acts, B, kind) in enumerate(steps):
        args = train_step_inputs(90 + n, dims, B, kind) + (0.1, acts)
        loss_r, ws_r, bs_r = K.fused_mlp_train_step_ref(*args,
                                                        loss_kind=kind)
        loss, ws, bs = K._fused_mlp_train_step_cuda(*args, kind)
        torch.cuda.synchronize()
        e_loss = max_err(loss, loss_r, TOL_LOSS)
        e_par = max(max_err(a, b, TOL_PARAM)
                    for a, b in zip(ws + bs, ws_r + bs_r))
        worst["fused_mlp_train_step"] = max(
            worst["fused_mlp_train_step"], e_loss, e_par)
        log(f"[kernel] fused_mlp_train_step {kind} B={B} "
            f"{'-'.join(map(str, dims))} loss {float(loss):.6f} max|err| "
            f"loss {e_loss:.2e} (tol {TOL_LOSS[0]:g}+{TOL_LOSS[1]:g}|ref|), "
            f"params {e_par:.2e} (tol {TOL_PARAM[0]:g}+{TOL_PARAM[1]:g}|ref|)")
    # the flagship at B = 1000 once more: the step repeats bit for bit
    args = train_step_inputs(93, FLAGSHIP, 1000, "softmax_xent") + (
        0.1, ("logistic", "logistic", "identity"))
    a = K._fused_mlp_train_step_cuda(*args, "softmax_xent")
    b = K._fused_mlp_train_step_cuda(*args, "softmax_xent")
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in
               zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]))
    check(same, "fused_mlp_train_step: two runs on one input differ")
    log("[kernel] fused_mlp_train_step flagship B=1000 twice: bit-equal")
    return worst


def big_linear_inputs():
    """x (4096, 4096) uniform, w (4096, 4096) N(0, 1/64²), b N(0, 1), made
    on the card from one seed: kernel 1's large instance."""
    g = torch.Generator(DEVICE).manual_seed(91)
    return (torch.rand(4096, 4096, device=DEVICE, generator=g),
            torch.randn(4096, 4096, device=DEVICE, generator=g) / 64,
            torch.randn(4096, device=DEVICE, generator=g))


def bf16_y_ulps(y, y_ref, z_ref):
    """The largest |y - y_ref| in bf16 ulps of y_ref, the count of values
    beyond one ulp and the largest |y_ref| among them, and the count of
    values, after checking every element against one ulp plus z's
    tolerance (see BF16_ULP)."""
    y, y_ref, z_ref = (t.double().cpu() for t in (y, y_ref, z_ref))
    check(bool(torch.isfinite(y).all()), "non-finite bf16 output")
    ulp = torch.exp2(torch.floor(torch.log2(
        y_ref.abs().clamp_min(2.0 ** -126)))) * BF16_ULP
    diff = (y - y_ref).abs()
    check(bool((diff <= ulp + TOL_Z[0] + TOL_Z[1] * z_ref.abs()).all()),
          f"bf16 y beyond one ulp: max {float((diff / ulp).max()):.2f} ulps")
    beyond = diff > ulp
    return ((float((diff / ulp).max()) if diff.numel() else 0.0),
            int(beyond.sum()), float(y_ref.abs()[beyond].max())
            if beyond.any() else 0.0, diff.numel())


def phase_linear_bf16() -> float:
    """Kernel 1's bf16 instance against its plain version at the flagship's
    layers and a ragged shape, every activation, with and without z; each
    call's launch counted; the wrapper's backward keeps the JAX VJP's
    dtypes.  Returns the largest |z - z_ref|."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst, ulps, calls, beyond, beyond_y, elems = 0.0, 0.0, 0, 0, 0.0, 0
    before = K.launch_counts()["fused_linear"]
    shapes = [(B, FLAGSHIP[i], FLAGSHIP[i + 1])
              for B in (1, 8, 17, 100, 512) for i in range(3)] + [
                  (33, 40, 10)]
    for n, (B, Kd, O) in enumerate(shapes):
        x = _rand(150 + n, B, Kd, uniform=True).to(torch.bfloat16)
        w = _rand(160 + n, O, Kd, scale=0.5)
        b = _rand(170 + n, O, scale=0.5)
        for act in ACTS:
            for save_z in (False, True):
                y, z = K._fused_linear_cuda(x, w, b, act, save_z)
                calls += 1
                torch.cuda.synchronize()
                y_ref, z_ref = K.fused_linear_ref(x, w, b, act, save_z=True)
                check(y.dtype == torch.bfloat16 and (z is None or
                                                      z.dtype == torch.float32),
                      f"bf16 fused_linear gave y {y.dtype}")
                u, nb, yb, ne = bf16_y_ulps(y, y_ref, z_ref)
                ulps, beyond, beyond_y = max(ulps, u), beyond + nb, max(
                    beyond_y, yb)
                elems += ne
                if save_z:
                    worst = max(worst, max_err(z, z_ref, TOL_Z))
    check(K.launch_counts()["fused_linear"] - before == calls,
          f"bf16 fused_linear: {calls} calls, launches "
          f"{K.launch_counts()['fused_linear'] - before}")
    # through the public wrapper: a differentiable call keeps z, and the
    # backward gives dx and dw in bf16, db in f32 (the JAX VJP's dtypes)
    x = _rand(180, 8, 300, uniform=True).to(torch.bfloat16).requires_grad_()
    w = _rand(181, 100, 300, scale=0.1).to(torch.bfloat16).requires_grad_()
    b = _rand(182, 100, scale=0.5).requires_grad_()
    K.fused_linear(x, w, b, "logistic").float().sum().backward()
    torch.cuda.synchronize()
    check((x.grad.dtype, w.grad.dtype, b.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32),
        f"bf16 grads {x.grad.dtype} {w.grad.dtype} {b.grad.dtype}")
    log(f"[kernel] fused_linear bf16 operands: {calls} launches counted "
        f"(B=1, 8, 17, 100, 512 at the flagship's layers and 33x40->10: "
        f"the gemv and the tile with its split, every act, with and without "
        f"z); y max {ulps:.2f} bf16 ulps of the plain y "
        f"(tol 1 ulp + {TOL_Z[0]:g}+{TOL_Z[1]:g}|z|), beyond one ulp in "
        f"{beyond} of {elems} values, all with |y| <= {beyond_y:.2e}; z "
        f"max|err| "
        f"{worst:.2e} (tol {TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|); grads dx, dw "
        f"bf16, db f32")
    return worst


def train_step_inputs(seed: int, dims, B: int, kind: str):
    """x (pixel-like), y (one-hot, or x itself for the squared error) and
    weights at a trained net's 1/sqrt(fan-in) scale, on the card."""
    r = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    x = r.uniform(0, 1, size=(B, dims[0]))
    y = (np.eye(dims[-1])[r.integers(0, dims[-1], size=B)]
         if kind == "softmax_xent" else x)
    ws = [dev(r.normal(size=(dims[k + 1], dims[k])) / np.sqrt(dims[k]))
          for k in range(len(dims) - 1)]
    bs = [dev(r.normal(size=dims[k + 1]) * 0.3)
          for k in range(len(dims) - 1)]
    return dev(x), dev(y), ws, bs


def int8_stack_cpu():
    """The 4 x 4096 serving stack as a plain ``QuantizedMLP`` on the CPU:
    weights normal * sqrt(2/N) from ``default_rng(0)``, zero biases, acts
    relu, relu, relu, identity, raw logits out; and its batch of 16 rows
    drawn next from the same generator."""
    from tensor_ops_tpu_torch.models import FusedMLP, QuantizedMLP

    r = np.random.default_rng(0)
    n = STACK_N
    ws = [(r.normal(size=(n, n)) * math.sqrt(2.0 / n)).astype(np.float32)
          for _ in range(STACK_L)]
    x = r.normal(size=(STACK_B, n)).astype(np.float32)
    fm = FusedMLP.from_numpy(ws, [np.zeros(n, np.float32)] * STACK_L,
                             STACK_ACTS, softmax_out=False, device="cpu")
    return QuantizedMLP.from_fused(fm), ws, x


def phase_int8_kernels(stack) -> dict:
    """Kernels 4-6 against their plain versions on the card."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = {"fused_linear_w8": 0.0, "fused_linear_w8a8": 0.0,
             "fused_mlp_w8a8_forward": 0.0}

    def layer(seed, B, Kd, O):
        x = _rand(seed, B, Kd, uniform=True)
        w = _rand(seed + 1, O, Kd, scale=1 / math.sqrt(Kd))
        b = _rand(seed + 2, O, scale=0.3)
        q, s = K.quantize_weights_int8(w)
        return x, q, s, b

    shapes = [(B, FLAGSHIP[i], FLAGSHIP[i + 1])
              for B in (1, 8, 37) for i in range(3)]
    for n, (B, Kd, O) in enumerate(shapes):
        x, q, s, b = layer(300 + 3 * n, B, Kd, O)
        errs = []
        for prec in ("default", "highest"):
            for act in ("logistic", "identity"):
                y = K._fused_linear_w8_cuda(x, q, s, b, act, prec)
                torch.cuda.synchronize()
                e = max_err(y, K.fused_linear_w8_ref(x, q, s, b, act, prec),
                            TOL_Z)
                worst["fused_linear_w8"] = max(worst["fused_linear_w8"], e)
                errs.append(f"{prec}/{act} {e:.1e}")
        log(f"[kernel] fused_linear_w8 B={B} {Kd}->{O} max|err| "
            f"{', '.join(errs)}; tol {TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|")

    for n, (B, Kd, O) in enumerate(shapes + [(40, 257, 130)]):
        x, q, s, b = layer(400 + 3 * n, B, Kd, O)
        x = x * 4 - 2  # signed activations
        errs = []
        for act in ("identity", "relu", "logistic", "tanh"):
            y = K._fused_linear_w8a8_cuda(x, q, s, b, act)
            torch.cuda.synchronize()
            ref = K.fused_linear_w8a8_ref(x, q, s, b, act)
            if act in ("identity", "relu"):
                check(torch.equal(y, ref), f"fused_linear_w8a8 {act} B={B} "
                      f"{Kd}->{O}: not bit-equal to its plain version")
                e = 0.0
            else:
                e = max_err(y, ref, TOL_ACT)
            worst["fused_linear_w8a8"] = max(worst["fused_linear_w8a8"], e)
            errs.append(f"{act} {e:.1e}")
        log(f"[kernel] fused_linear_w8a8 B={B} {Kd}->{O} (K padded to "
            f"{K.padded_width(Kd)}) identity, relu bit-equal; max|err| "
            f"{', '.join(errs)}; tol {TOL_ACT[0]:g}")
    r = np.random.default_rng(7)
    xi = r.integers(-127, 128, size=(5, 12)).astype(np.float32)
    xi[:, 0] = 127.0  # scale 1: the codes are x itself
    wi = r.integers(-127, 128, size=(9, 12)).astype(np.int8)
    y = K._fused_linear_w8a8_cuda(
        torch.as_tensor(xi, device=DEVICE), torch.as_tensor(wi, device=DEVICE),
        torch.ones(9, 1, device=DEVICE), torch.zeros(9, device=DEVICE),
        "identity")
    torch.cuda.synchronize()
    exact = xi.astype(np.int64) @ wi.astype(np.int64).T
    check(np.array_equal(y.cpu().numpy(), exact.astype(np.float32)),
          "fused_linear_w8a8: the int32-exact case is not exact")
    log("[kernel] fused_linear_w8a8 int32-exact case (B=5, 12->9): exact")

    wq3, sw2, b2 = (t.to(DEVICE) for t in stack["model"]._cache["stacked"])
    cases = [(B, wq3, sw2, b2, "relu") for B in (STACK_B, 5)]
    rs = np.random.default_rng(8)
    small = torch.as_tensor(rs.normal(size=(3, 512, 512)) / math.sqrt(512),
                            dtype=torch.float32)
    q3, s3 = zip(*(K.quantize_weights_int8(w) for w in small))
    cases.append((37, torch.stack(q3).to(DEVICE),
                  torch.stack([s.reshape(-1) for s in s3]).to(DEVICE),
                  torch.zeros(3, 512, device=DEVICE), "logistic"))
    for n, (B, wq, sw, bb, act) in enumerate(cases):
        L, N = wq.shape[0], wq.shape[1]
        x = torch.as_tensor(stack["x"][:B] if N == STACK_N
                            else rs.normal(size=(B, N)).astype(np.float32),
                            device=DEVICE)
        y = K._fused_mlp_w8a8_forward_cuda(x, wq, sw, bb, act)
        h = x
        for l in range(L):
            h = K._fused_linear_w8a8_cuda(h, wq[l], sw[l], bb[l],
                                          act if l < L - 1 else "identity")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), "fused_mlp_w8a8_forward: "
              "non-finite output")
        check(torch.equal(y, h), f"fused_mlp_w8a8_forward {L}x{N} B={B} "
              f"{act}: not bit-equal to the per-layer CUDA chain")
        ref = K.fused_mlp_w8a8_forward_ref(x, wq, sw, bb, act)
        if act == "relu":
            check(torch.equal(y, ref), f"fused_mlp_w8a8_forward {L}x{N} "
                  f"B={B}: not bit-equal to its plain version")
            e = 0.0
            what = "bit-equal to its plain version"
        else:
            # a logistic layer's values lie in [0, 1]: its row scale is at
            # most 1/127, so one code flipped by an ulp of expf moves a
            # logit by at most the last layer's largest weight scale
            step = float(sw[-1].max())
            e = max_err(y, ref, (step, 0.0))
            what = (f"max|err| {e:.2e} against its plain version (tol one "
                    f"code step {step:.2e})")
        worst["fused_mlp_w8a8_forward"] = max(
            worst["fused_mlp_w8a8_forward"], e)
        log(f"[kernel] fused_mlp_w8a8_forward {L}x{N} B={B} {act}: "
            f"bit-equal to the per-layer CUDA chain, {what}; rows/block "
            f"{K.int8_tile_rows(B, N, 1)}")
    return worst


def _served_probs(stdout: str, n: int) -> np.ndarray:
    rows = [l for l in stdout.splitlines()
            if l and (l[0].isdigit() or l[0] == "-")]
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
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the slice")
    return {"launches": launches, "model": model, "ckpt": ckpt}


def _run_app(argv) -> str:
    from tensor_ops_tpu_torch.apps import serve as serve_app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main(argv)
    return buf.getvalue()


def _resident(load):
    """A model loaded by ``load()`` (with its input width) and the device
    bytes it holds: ``torch.cuda.memory_allocated`` before loading and after
    one forward, so the kernels' cached forms of the weights count."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model, width = load()
    with torch.inference_mode():
        model.run(torch.zeros(1, width, device=DEVICE))
    torch.cuda.synchronize()
    return model, torch.cuda.memory_allocated() - before


def phase_int8_serving(tmp: str, ckpt: str, stack) -> dict:
    """The serve app on the three int8 routes, each driven with the launch
    counts set to 0 just before and read just after."""
    from tensor_ops_tpu_torch.apps import serve as serve_app
    from tensor_ops_tpu_torch.models import FusedMLP, QuantizedMLP
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_arrays,
                                                       load_quantized,
                                                       save_quantized)

    buckets = ",".join(map(str, BUCKETS))
    x = np.random.default_rng(3).uniform(0, 1, size=(64, FLAGSHIP[0]))
    x = x.astype(np.float32)
    xfile = os.path.join(tmp, "int8_batch.npy")
    np.save(xfile, x)
    payload = load_arrays(ckpt)
    layers, cpu = list(FLAGSHIP[1:-1]), torch.device("cpu")
    f32_cpu = serve_app.load_model(payload, layers, FLAGSHIP[0], FLAGSHIP[-1],
                                   "logistic", cpu)
    plain = serve_app.load_model(payload, layers, FLAGSHIP[0], FLAGSHIP[-1],
                                 "logistic", cpu, int8=True)
    f32_classes = f32_cpu.run(torch.as_tensor(x)).numpy().argmax(1)
    out, launches = {}, {}
    # one code flipped by an ulp of expf moves a logit (and a probability)
    # by at most the last layer's largest weight scale (its input, a
    # logistic layer, has row scales <= 1/127); 5e-7 is the app's printing
    rounding = 5e-7
    step = float(plain.scales[-1].max())

    K.reset_launch_counts()
    served = _served_probs(_run_app(
        [ckpt, "--int8", "-i", xfile, "--probs", "--device", DEVICE,
         "--buckets", buckets]), len(x))
    torch.cuda.synchronize()
    launches["fused_linear_w8a8"] = K.launch_counts()["fused_linear_w8a8"]
    check(launches["fused_linear_w8a8"] == 3, f"--int8 flagship: "
          f"{launches['fused_linear_w8a8']} fused_linear_w8a8 launches for "
          f"one request, want 3")
    want = plain.run(torch.as_tensor(x)).numpy()
    e = max_err(torch.as_tensor(served), torch.as_tensor(want),
                (step + rounding, 0.0))
    agree = float((served.argmax(1) == f32_classes).mean())
    check(agree > 0.8, f"--int8 classes agree with f32 on {agree:.3f} < 0.8")
    log(f"[int8] serve app --int8 (w8a8) on the flagship checkpoint, "
        f"{len(x)} rows: 3 fused_linear_w8a8 launches; vs the plain "
        f"QuantizedMLP on the CPU max|err| {e:.2e} (tol one code step "
        f"{step:.2e} + {rounding:g}); classes agree with f32 on "
        f"{agree:.3f} (JAX test: > 0.8)")
    out["w8a8_err"] = e

    w8 = QuantizedMLP.from_fused(f32_cpu, mode="w8")
    w8path = os.path.join(tmp, "flagship_w8.npz")
    save_quantized(w8path, w8)
    K.reset_launch_counts()
    served = _served_probs(_run_app(
        [w8path, "-i", xfile, "--probs", "--device", DEVICE, "--buckets",
         buckets]), len(x))
    torch.cuda.synchronize()
    launches["fused_linear_w8"] = K.launch_counts()["fused_linear_w8"]
    check(launches["fused_linear_w8"] == 3, f"w8 checkpoint: "
          f"{launches['fused_linear_w8']} fused_linear_w8 launches, want 3")
    want = w8.run(torch.as_tensor(x)).numpy()
    e = max_err(torch.as_tensor(served), torch.as_tensor(want),
                (TOL_P[0] + rounding, 0.0))
    agree = float((served.argmax(1) == f32_classes).mean())
    check(agree > 0.8, f"w8 classes agree with f32 on {agree:.3f} < 0.8")
    log(f"[int8] serve app on a mode=w8 quantized_mlp checkpoint: 3 "
        f"fused_linear_w8 launches; vs the plain QuantizedMLP on the CPU "
        f"max|err| {e:.2e} (tol {TOL_P[0]:g} + {rounding:g}); classes "
        f"agree with f32 on {agree:.3f}")

    qm, xs = stack["model"], stack["x"]
    spath = os.path.join(tmp, "stack_4x4096.npz")
    save_quantized(spath, qm)
    xsfile = os.path.join(tmp, "stack_batch.npy")
    np.save(xsfile, xs)
    K.reset_launch_counts()
    served = _served_probs(_run_app(
        [spath, "-i", xsfile, "--probs", "--device", DEVICE, "--in-dim",
         str(STACK_N), "--out-dim", str(STACK_N), "--buckets",
         str(STACK_B)]), len(xs))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    launches["fused_mlp_w8a8_forward"] = counts["fused_mlp_w8a8_forward"]
    check(counts["fused_mlp_w8a8_forward"] == 1
          and counts["fused_linear_w8a8"] == 0,
          f"4x4096 stack: launches {counts}, want one fused_mlp_w8a8_forward")
    want = qm.run_fused(torch.as_tensor(xs))
    e = max_err(torch.as_tensor(served), want, (rounding, 0.0))
    gpu_qm = load_quantized(spath, device=DEVICE)
    with torch.inference_mode():
        got = gpu_qm.run_fused(torch.as_tensor(xs, device=DEVICE))
    check(torch.equal(got.cpu(), want), "4x4096 stack on the card is not "
          "bit-equal to the plain QuantizedMLP on the CPU")
    log(f"[int8] serve app on the 4x4096 quantized_mlp checkpoint, B=16: one "
        f"fused_mlp_w8a8_forward launch; printed logits vs the plain "
        f"QuantizedMLP on the CPU max|err| {e:.2e} (tol {rounding:g}, the "
        f"printing); run_fused on the card bit-equal to it")

    sizes = {}
    for name, load in (
            ("flagship f32", lambda: (serve_app.load_model(
                payload, layers, FLAGSHIP[0], FLAGSHIP[-1], "logistic",
                torch.device(DEVICE)), FLAGSHIP[0])),
            ("flagship int8 (w8a8)", lambda: (serve_app.load_model(
                payload, layers, FLAGSHIP[0], FLAGSHIP[-1], "logistic",
                torch.device(DEVICE), int8=True), FLAGSHIP[0])),
            ("4x4096 f32", lambda: (FusedMLP.from_numpy(
                stack["weights"], [np.zeros(STACK_N, np.float32)] * STACK_L,
                STACK_ACTS, softmax_out=False, device=DEVICE), STACK_N)),
            ("4x4096 int8", lambda: (load_quantized(spath, device=DEVICE),
                                     STACK_N))):
        model, nbytes = _resident(load)
        sizes[name] = nbytes
        del model
        log(f"[int8] device memory held by the {name} model: {nbytes} bytes "
            f"(torch.cuda.memory_allocated before and after loading and one "
            f"forward)")
    out.update(launches=launches, int8_flagship=plain, gpu_stack=gpu_qm,
               w8=w8)
    return out


@contextlib.contextmanager
def no_download():
    """The loader's download attempt fails at once, without a socket: this
    smoke run never reaches for the network, and the app falls back to its
    synthetic set as it does offline."""
    from tensor_ops_tpu_torch.utils import mnist_data

    def refuse(url, timeout=20.0):
        raise OSError(f"no network in this smoke run ({url})")

    saved, mnist_data._fetch = mnist_data._fetch, refuse
    try:
        yield
    finally:
        mnist_data._fetch = saved


def run_mnist_app(tmp: str, extra) -> dict:
    """``apps.mnist.main`` for one epoch of the synthetic set at the
    flagship's widths, in a fresh data directory; the training errors, the
    samples/s after the first (warm-up) batch from the app's own per-batch
    ``--metrics`` record, and the launch counts."""
    from tensor_ops_tpu_torch.apps import mnist
    from tensor_ops_tpu_torch.ops import kernels as K

    data = tempfile.mkdtemp(dir=tmp)
    record = os.path.join(data, "metrics.jsonl")
    argv = ["--epochs", "1", "-b", "1000", "-d", data, "--device", DEVICE,
            "--seed", "0", "--metrics", record, *extra]
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with no_download(), contextlib.redirect_stdout(buf):
        mnist.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    lines = buf.getvalue().splitlines()
    i_loaded = lines.index("Loaded data.")
    check(any("SYNTHETIC" in l for l in lines[:i_loaded]),
          "the app did not fall back to the synthetic set")
    train = [float(l.split()[1].rstrip("%")) for l in lines
             if l.startswith("Training:")]
    val = [float(l.split()[1].rstrip("%")) for l in lines
           if l.startswith("Validation:")]
    with open(record) as f:
        seconds = [json.loads(l)["batch_seconds"] for l in f]
    check(len(train) == len(val) == len(seconds) == 6,
          f"{' '.join(extra)}: {len(train)} training and {len(val)} "
          f"validation errors for 6 batches")
    check(train[-1] < train[0], f"{' '.join(extra)}: training error did not "
          f"fall ({train})")
    rate = 5 * 1000 / sum(seconds[1:])
    log(f"[train] mnist {' '.join(extra)}: {wall:.1f} s in all; training "
        f"error {train} %, validation error {val} %; {rate:.0f} samples/s "
        f"over batches 2-6 (batch 1: {seconds[0] * 1e3:.2f} ms); launches "
        f"{launches}")
    return {"launches": launches, "samples_per_s": rate}


def phase_train(tmp: str) -> dict:
    from tensor_ops_tpu_torch.models import FusedMLP
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.mnist_data import load_mnist

    t0 = time.perf_counter()
    with no_download(), contextlib.redirect_stdout(io.StringIO()):
        train_raw, _ = load_mnist(tempfile.mkdtemp(dir=tmp))
    log(f"[train] offline fallback to the synthetic set in a fresh data "
        f"directory: {time.perf_counter() - t0:.2f} s "
        f"({len(train_raw)} training rows)")

    fused = run_mnist_app(tmp, ["--minibatch", "100", "--fused"])
    check(fused["launches"]["fused_mlp_train_step"] > 0,
          "the --fused run did not launch fused_mlp_train_step")
    minibatch = run_mnist_app(tmp, ["--minibatch", "100"])

    # 5 steps on one fixed minibatch of the synthetic set, from one start
    xb = np.stack([d / 255.0 for _, d in train_raw[:100]])
    yb = np.eye(10)[[l for l, _ in train_raw[:100]]]
    r = np.random.default_rng(5)
    ws = [r.normal(size=(FLAGSHIP[k + 1], FLAGSHIP[k])) * 0.5
          for k in range(3)]
    bs = [r.normal(size=FLAGSHIP[k + 1]) * 0.5 for k in range(3)]
    acts = ("logistic", "logistic", "identity")
    kernel = plain = FusedMLP.from_numpy(
        [w.astype(np.float32) for w in ws],
        [b.astype(np.float32) for b in bs], acts, device=DEVICE)
    x32 = torch.as_tensor(xb, dtype=torch.float32, device=DEVICE)
    y32 = torch.as_tensor(yb, dtype=torch.float32, device=DEVICE)
    ws64, bs64 = ([torch.as_tensor(w) for w in ws],
                  [torch.as_tensor(b) for b in bs])
    x64, y64 = torch.as_tensor(xb), torch.as_tensor(yb)
    for _ in range(5):
        _, kernel = kernel.train_fullfused(TRAIN_RATE, x32, y32)
        _, plain = plain.train(TRAIN_RATE, x32, y32)
        _, ws64, bs64 = K.fused_mlp_train_step_ref(
            x64, y64, ws64, bs64, TRAIN_RATE, acts)
    torch.cuda.synchronize()
    for what, ref in (("FusedMLP.train on the card", plain.to_params()),
                      ("the plain step in CPU f64",
                       [p for wb in zip(ws64, bs64) for p in wb])):
        e = max(max_err(a, b, TOL_5_STEPS)
                for a, b in zip(kernel.to_params(), ref))
        log(f"[train] 5 train_fullfused steps (rate {TRAIN_RATE}, B=100) vs "
            f"{what}: max|err| {e:.2e} tol {TOL_5_STEPS[0]:g}+"
            f"{TOL_5_STEPS[1]:g}|ref|")
    return {"fused": fused, "minibatch": minibatch}


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
                small = hs[:3]
        # the flagship's last layer runs as an identity layer under
        # softmax_out, where one torch.addmm computes what kernel 1 does:
        # that call is kernel 1's library time (the kernels line's entry)
        h100 = [_rand(75, 100, FLAGSHIP[0], uniform=True)]
        for w, b, a in zip(ws, bs, acts):
            h100.append(K.fused_linear_ref(h100[-1], w, b, a))
        cases = (("identity layer 100->10, B=8", [(small[2], ws[2], bs[2])]),
                 ("784->300, B=8", [(small[0], ws[0], bs[0])]),
                 ("the three flagship layers, B=100",
                  list(zip(h100[:3], ws, bs))),
                 ("4096^3", [big_linear_inputs()]))
        for what, layers in cases:
            times_l = linear_timing(what, layers)
            if what.startswith("identity"):
                times["fused_linear"] = times_l
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

    times["fused_mlp_train_step"] = train_step_timing()
    return times


def linear_timing(what: str, layers) -> tuple:
    """Kernel 1 (identity epilogue) on ``layers`` (x, w, b) one after
    another against one ``torch.addmm`` per layer: CUDA-event medians and
    profiler device time of both, in turns over 3 repetitions, beside the
    bound.  Returns (kernel ms, plain ms, addmm ms, kernel device us) as
    the kernels line takes them."""
    from tensor_ops_tpu_torch.ops import kernels as K

    def kernel():
        for h, w, b in layers:
            K._fused_linear_cuda(h, w, b, "identity", False)

    def library():
        for h, w, b in layers:
            torch.addmm(b, h, w.T)

    plans = [K.linear_plan(h.shape[0], h.shape[1], w.shape[0])
             for h, w, _ in layers]
    names = {"linear_gemv_kernel" if p.instance == "gemv"
             else "linear_tile_kernel" for p in plans}
    e = max(max_err(K._fused_linear_cuda(h, w, b, "identity", False)[0],
                    torch.addmm(b, h, w.T), TOL_Z) for h, w, b in layers)
    reps = []
    for _ in range(3):
        prof = _profile_steps(kernel)
        check(set(prof["by_kernel"]) == names, f"fused_linear {what}: the "
              f"profiler saw {sorted(prof['by_kernel'])}, want {names}")
        lib = _profile_steps(library)
        reps.append((_median_ms(kernel), _median_ms(library),
                     prof["busy_us"], lib["busy_us"]))
    k_ms, l_ms, k_us, l_us = (statistics.median(r[i] for r in reps)
                              for i in range(4))
    p_ms = _median_ms(lambda: [K.fused_linear_ref(h, w, b)
                               for h, w, b in layers])
    parts = [_bound(4 * (h.shape[0] * h.shape[1] + w.numel() + w.shape[0]
                         + h.shape[0] * w.shape[0]),
                    2 * h.shape[0] * h.shape[1] * w.shape[0], "f32")
             for h, w, _ in layers]
    least = (sum(p[0] for p in parts), max(parts)[1])
    log(f"[timing] fused_linear {what}: instances "
        f"{', '.join(f'{p.instance} grid {p.grid}' for p in plans)}; device "
        f"(profiler), in turns over 3 repetitions, kernel "
        f"{', '.join(f'{r[2]:.2f}' for r in reps)} us vs torch.addmm "
        f"{', '.join(f'{r[3]:.2f}' for r in reps)} us (medians {k_us:.2f} vs "
        f"{l_us:.2f} us: {k_us / l_us:.2f}x); events kernel "
        f"{', '.join(f'{r[0]:.4f}' for r in reps)} ms vs torch.addmm "
        f"{', '.join(f'{r[1]:.4f}' for r in reps)} ms (medians {k_ms:.4f} vs "
        f"{l_ms:.4f} ms); plain {p_ms:.4f} ms; bound {least[0] * 1e3:.4f} us "
        f"by {least[1]}; kernel vs addmm max|err| {e:.1e}")
    return k_ms, p_ms, l_ms, k_us


def train_step_timing() -> tuple:
    """Kernel 3 on the flagship at B = 100, 400, 1000 by CUDA events and
    by profiler device time, with the grid and the barrier count.  Returns
    (kernel ms, plain ms) at B = 100."""
    from tensor_ops_tpu_torch.ops import kernels as K

    acts = ("logistic", "logistic", "identity")
    grid = K.train_grid(K._train_step_capacity(0), K._sm_count(0), 100,
                        FLAGSHIP)
    stages = K.train_stages(len(FLAGSHIP) - 1)
    log(f"[timing] fused_mlp_train_step: grid {grid} blocks of "
        f"{K.TRAIN_THREADS} threads (one per SM; the card holds "
        f"{K._train_step_capacity(0)}), {len(stages)} stages "
        f"{'/'.join(stages)}, {len(stages) - 1} grid barriers")
    out = None
    for B in (100, 400, 1000):
        x, y, tw, tb = train_step_inputs(110 + B, FLAGSHIP, B, "softmax_xent")

        def step():
            return K._fused_mlp_train_step_cuda(x, y, tw, tb, 0.1, acts,
                                                "softmax_xent")
        prof = _profile_steps(step)
        # names only: the profiler may drop an event (its count is no
        # launch count)
        check(list(prof["by_kernel"]) == ["mlp_train_step_kernel"],
              f"fused_mlp_train_step: the profiler saw "
              f"{sorted(prof['by_kernel'])}")
        k_ms = _median_ms(step)
        p_ms = _median_ms(lambda: K.fused_mlp_train_step_ref(
            x, y, tw, tb, 0.1, acts))
        log(f"[timing] fused_mlp_train_step B={B} flagship: events "
            f"{k_ms:.4f} ms, device {prof['busy_us']:.2f} us; plain "
            f"{p_ms:.4f} ms")
        if B == 100:
            out = (k_ms, p_ms)
    return out


def _per_launch_us(prof: dict, kernel: str) -> float:
    """A kernel's device time per launch the profiler saw (0 if none)."""
    calls = prof["calls"].get(kernel, 0)
    return prof["by_kernel"][kernel] / calls if calls else 0.0


def _host_us(fn, calls: int = 1000) -> float:
    """Host time per call of ``fn``: the host clock over ``calls`` calls
    after warm-up, the card's queue drained before and not waited on
    inside (the card keeps up when each call's kernels are shorter than its
    host time)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _profile_steps(step, steps: int = 10) -> dict:
    """The device work of one call of ``step`` (a training step, a request
    or a kernel): CUDA kernels launched, copies and memsets, and device busy
    time per call (``torch.profiler`` over ``steps`` calls, kernel and copy
    rows only), and time and launches per call by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    # the profiler now and then hands back no device events at all (seen
    # once in a dozen runs on the card): profile again, at most twice more
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if device:
            break
    by_kernel, calls, launches, copies, busy = {}, {}, 0, 0, 0.0
    for e in device:
        us = e.time_range.elapsed_us()
        busy += us
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            launches += 1
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0].split("<")[0]
        name = name.split("::")[-1]
        by_kernel[name] = by_kernel.get(name, 0.0) + us / steps
        calls[name] = calls.get(name, 0) + 1
    return {"launches": launches / steps, "copies": copies / steps,
            "busy_us": busy / steps,
            "calls": {n: c / steps for n, c in calls.items()},
            "by_kernel": dict(sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1]))}


def phase_int8_timing(sv, stack) -> dict:
    """int8 serving on the card: p50 request latency per bucket, each int8
    kernel's CUDA-event median beside its plain version's and its profiler
    device time, and where one request's time goes on each int8 route."""
    from tensor_ops_tpu_torch.models import Predictor
    from tensor_ops_tpu_torch.ops import kernels as K

    qm_flag = sv["int8_flagship"]
    flag = type(qm_flag)(*(tuple(t.to(DEVICE) for t in ts) for ts in (
        qm_flag.wqs, qm_flag.scales, qm_flag.biases)), qm_flag.acts,
        qm_flag.softmax_out, qm_flag.mode)
    w8 = type(flag)(flag.wqs, flag.scales, flag.biases, flag.acts,
                    flag.softmax_out, "w8")
    stack_gpu = sv["gpu_stack"]
    r = np.random.default_rng(4)
    preds = [("int8 flagship (w8a8, fused_linear_w8a8 x3)",
              Predictor(flag, buckets=BUCKETS), BUCKETS, FLAGSHIP[0]),
             ("w8 flagship (fused_linear_w8 x3)",
              Predictor(w8, buckets=BUCKETS), BUCKETS, FLAGSHIP[0]),
             ("4x4096 stack (fused_mlp_w8a8_forward)",
              Predictor(stack_gpu, buckets=(STACK_B,)), (STACK_B,), STACK_N)]
    for name, pred, buckets, width in preds:
        pred.warmup()
        for b in buckets:
            x = r.uniform(0, 1, size=(b, width)).astype(np.float32)
            pred.timer.samples.clear()
            for _ in range(TIMED_RUNS):
                pred.predict(x)
            log(f"[timing] {name} Predictor bucket {b}: p50 "
                f"{pred.latency()['p50_s'] * 1e3:.4f} ms host clock "
                f"(n={TIMED_RUNS})")
        b = buckets[0]
        x = r.uniform(0, 1, size=(b, width)).astype(np.float32)
        for _ in range(3):
            pred.predict(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            pred.predict(x)
        wall_us = (time.perf_counter() - t0) / 20 * 1e6
        prof = _profile_steps(lambda: pred.predict(x))
        top = ", ".join(f"{n} {us:.1f}" for n, us in
                        list(prof["by_kernel"].items())[:3])
        log(f"[timing] request bucket {b} {name}: {wall_us:.1f} us/request "
            f"wall, {prof['launches']:.0f} kernels + {prof['copies']:.0f} "
            f"copies/request, device busy {prof['busy_us']:.1f} us/request, "
            f"idle share {1 - prof['busy_us'] / wall_us:.3f}; largest "
            f"(us/request): {top}")

    times = {}
    with torch.inference_mode():
        B = 8
        hs = [_rand(500, B, FLAGSHIP[0], uniform=True)]
        for q, s_, b, a in zip(flag._padded(), flag.scales, flag.biases,
                               FLAGSHIP_INT8_ACTS):
            hs.append(K.fused_linear_w8a8_ref(hs[-1], q, s_, b, a))
        for name, cuda, ref in (
                ("fused_linear_w8", lambda h, q, s_, b, a:
                 K._fused_linear_w8_cuda(h, q, s_, b, a, "default"),
                 lambda h, q, s_, b, a:
                 K.fused_linear_w8_ref(h, q, s_, b, a, "default")),
                ("fused_linear_w8a8", K._fused_linear_w8a8_cuda,
                 K.fused_linear_w8a8_ref)):
            tk = tp = dev = 0.0
            for i, (q, s_, b, a) in enumerate(zip(
                    flag._padded(), flag.scales, flag.biases,
                    FLAGSHIP_INT8_ACTS)):
                h = hs[i]
                k_ms = _median_ms(lambda: cuda(h, q, s_, b, a))
                p_ms = _median_ms(lambda: ref(h, q, s_, b, a))
                d = _profile_steps(lambda: cuda(h, q, s_, b, a))["busy_us"]
                tk, tp, dev = tk + k_ms, tp + p_ms, dev + d
                log(f"[timing] {name} B={B} {FLAGSHIP[i]}->{FLAGSHIP[i + 1]} "
                    f"{a}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, device "
                    f"{d:.1f} us")
            log(f"[timing] {name} B={B} three flagship layers: kernel "
                f"{tk:.4f} ms, plain {tp:.4f} ms, device {dev:.1f} us")
            times[name] = (tk, tp)
        wq3, sw2, b2 = stack_gpu._cache["stacked"]
        x = torch.as_tensor(stack["x"], device=DEVICE)
        k_ms = _median_ms(lambda: K._fused_mlp_w8a8_forward_cuda(
            x, wq3, sw2, b2, "relu"))
        p_ms = _median_ms(lambda: K.fused_mlp_w8a8_forward_ref(
            x, wq3, sw2, b2, "relu"))

        def chain():
            h = x
            for l in range(STACK_L):
                h = K._fused_linear_w8a8_cuda(h, wq3[l], sw2[l], b2[l],
                                              STACK_ACTS[l])
            return h

        c_ms = _median_ms(chain)
        prof = _profile_steps(lambda: K._fused_mlp_w8a8_forward_cuda(
            x, wq3, sw2, b2, "relu"))
        gemm_us = prof["by_kernel"].get("w8a8_gemm_kernel", 0.0)
        check(gemm_us > 0, f"the profiler saw the stack's kernels as "
              f"{sorted(prof['by_kernel'])}")
        log(f"[timing] fused_mlp_w8a8_forward 4x4096 B={STACK_B}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, per-layer "
            f"fused_linear_w8a8 chain {c_ms:.4f} ms; device "
            f"{prof['busy_us']:.1f} us in {prof['launches']:.0f} kernels ("
            + ", ".join(f"{n} {us:.1f} us" for n, us in
                        prof["by_kernel"].items())
            + f"); the products stream the int8 weights at "
            f"{STACK_L * STACK_N * STACK_N / (gemm_us * 1e-6) / 1e9:.0f} GB/s")
        times["fused_mlp_w8a8_forward"] = (k_ms, p_ms)
    return times


def phase_train_routes() -> None:
    """Where a flagship training step's time goes on the card at the
    app's minibatch of 100, for each route: wall time per step (host clock
    over 20 steps ending in a synchronise), kernels launched and device
    busy time per step (profiler), and the device's idle share."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (FusedMLP, act_logistic,
                                             act_softmax, cross_entropy,
                                             gen_net)
    from tensor_ops_tpu_torch.models.training import train_minibatch

    be = TorchBackend(torch.float32, DEVICE)
    net = gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                  [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                  act_softmax(), Rng(be, 0))
    fm = FusedMLP.from_network(net)
    loss = cross_entropy(FLAGSHIP[-1])
    x, y, _, _ = train_step_inputs(120, FLAGSHIP, 100, "softmax_xent")
    routes = {
        "--fused (train_fullfused)":
            lambda: fm.train_fullfused(TRAIN_RATE, x, y),
        "FusedMLP.train (fused_linear + autograd)":
            lambda: fm.train(TRAIN_RATE, x, y),
        "--minibatch (IR, vmapped)":
            lambda: train_minibatch(net, loss, be, TRAIN_RATE, x, y),
    }
    for name, step in routes.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / 20 * 1e6
        prof = _profile_steps(step)
        top = ", ".join(f"{n} {us:.1f}" for n, us in
                        list(prof["by_kernel"].items())[:3])
        log(f"[timing] step B=100 {name}: {wall_us:.1f} us/step wall, "
            f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} "
            f"copies/step, device busy "
            f"{prof['busy_us']:.1f} us/step, idle share "
            f"{1 - prof['busy_us'] / wall_us:.3f}; largest (us/step): {top}")

def rnn_step_inputs(seed: int, B: int, I: int, O: int):
    """x normal, s a logistic state in (0, 1), weights at 1/sqrt(I + O)
    scale and a bias, all f32 on the card."""
    r = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    k = math.sqrt(I + O)
    return (dev(r.normal(size=(B, I))),
            dev(1 / (1 + np.exp(-r.normal(size=(B, O))))),
            dev(r.normal(size=(O, I)) / k), dev(r.normal(size=(O, O)) / k),
            dev(r.normal(size=O) * 0.3))


def phase_rnn_kernels() -> float:
    """Kernel 7 against its plain version on the card: every activation at
    each shape, bit for bit on a rerun, and the gradients of the
    ``autograd.Function`` against autograd through the plain version."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = 0.0
    for n, (B, I, O) in enumerate(RNN_STEP_SHAPES):
        args = rnn_step_inputs(600 + n, B, I, O)
        errs = []
        for act in ACTS:
            y, s = K._fused_rnn_step_cuda(*args, act)
            y2, s2 = K._fused_rnn_step_cuda(*args, act)
            torch.cuda.synchronize()
            check(torch.equal(y, y2) and torch.equal(s, s2),
                  f"fused_rnn_step B={B} {I}->{O} {act}: a rerun differs")
            y_ref, s_ref = K.fused_rnn_step_ref(*args, act)
            e = max(max_err(y, y_ref, TOL_Z), max_err(s, s_ref, TOL_RNN_S))
            worst = max(worst, e)
            errs.append(f"{act} {e:.1e}")
        grads = []
        # relu's kink: a z within the sums' rounding of 0 takes the other
        # side in one version, so relu's gradients are compared where z
        # has few entries (B <= 37)
        for act in ACTS if B <= 37 else ("identity", "logistic", "tanh"):
            r = np.random.default_rng(700 + n)
            cy, cs = (torch.as_tensor(r.normal(size=(B, O)), dtype=torch.float32,
                                      device=DEVICE) for _ in range(2))
            sides = []
            for fn in (K.fused_rnn_step, K.fused_rnn_step_ref):
                ts = [a.clone().requires_grad_() for a in args]
                y, s = fn(*ts, act)
                ((y * cy).sum() + (s * cs).sum()).backward()
                sides.append([t.grad for t in ts])
            torch.cuda.synchronize()
            e = max(max_err(a, b, TOL_RNN_GRAD) for a, b in zip(*sides))
            grads.append(f"{act} {e:.1e}")
        log(f"[rnn-kernel] fused_rnn_step B={B} {I}->{O}: bit-equal on a "
            f"rerun; max|err| {', '.join(errs)} (y tol {TOL_Z[0]:g}+"
            f"{TOL_Z[1]:g}|ref|, s' tol {TOL_RNN_S[0]:g}); gradients of the "
            f"autograd.Function vs autograd through the plain version max|err| "
            f"{', '.join(grads)} (tol {TOL_RNN_GRAD[0]:g}+{TOL_RNN_GRAD[1]:g}"
            f"|ref|)")
    return worst


def rnn_model(be, seed: int = RNN_SEED):
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import act_logistic
    from tensor_ops_tpu_torch.models import recurrent as R

    lg = act_logistic
    return R.gen_net(be, RNN_IN, RNN_OUT, [(RNN_HIDDEN, lg(), lg())], lg(),
                     None, Rng(be, seed))


def phase_rnn_slice(tmp: str) -> dict:
    """The recurrent slice at full width: the serve app on a recurrent
    checkpoint, FusedRNN on the kernel route rebuilding the served
    trajectories, five training steps on both impls, and the offloaded
    tape."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import (FusedRNN, SequencePredictor,
                                             squared_error)
    from tensor_ops_tpu_torch.models.recurrent import seq_scan_op
    from tensor_ops_tpu_torch.ops import ir
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_arrays,
                                                       load_recurrent,
                                                       recurrent_from_arrays,
                                                       save_recurrent)

    be = TorchBackend(torch.float32, DEVICE)
    ckpt = os.path.join(tmp, "rnn.npz")
    save_recurrent(ckpt, rnn_model(be))
    xs = np.random.default_rng(0).standard_normal(
        (RNN_SEQS, RNN_N, RNN_IN)).astype(np.float32)
    xfile = os.path.join(tmp, "seqs.npy")
    np.save(xfile, xs)
    buckets = ",".join(map(str, RNN_BUCKETS))

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = _run_app([ckpt, "-i", xfile, "--probs", "--device", DEVICE,
                    "--buckets", buckets])
    torch.cuda.synchronize()
    app_launches = K.launch_counts()
    served = _served_probs(out, RNN_SEQS * RNN_N).reshape(
        RNN_SEQS, RNN_N, RNN_OUT)
    wall = time.perf_counter() - t0
    bench = json.loads(_run_app(
        [ckpt, "--bench", "--seq-len", str(RNN_N), "--device", DEVICE,
         "--buckets", buckets]).strip().splitlines()[-1])["latency"]
    log(f"[rnn] serve app: {RNN_SEQS} sequences of {RNN_N} steps through a "
        f"{RNN_IN}->[{RNN_HIDDEN}]->{RNN_OUT} recurrent checkpoint in "
        f"{wall:.1f} s (load, warm-up and one request; the IR scan, no hand "
        f"kernel: launches {app_launches}); --bench --seq-len {RNN_N} over "
        f"buckets {RNN_BUCKETS}: n={bench['n']}, p50 "
        f"{bench['p50_s'] * 1e3:.3f} ms")

    # the same checkpoint on the CPU, in f64 (the reference) and in f32
    # (the drift of an f32 recurrence of 64 steps from f64: the card's f32
    # runs are held to 1e-5 plus twice that, and the printing's rounding)
    arrays, meta = load_arrays(ckpt)
    cpu = {}
    for dt in (torch.float64, torch.float32):
        cb = TorchBackend(dt, "cpu")
        net_c = recurrent_from_arrays(arrays, meta, rnn_model(cb, 0), cb)
        cpu[dt] = SequencePredictor(net_c, cb, buckets=(RNN_SEQS,)).predict(xs)
    drift = float(np.abs(cpu[torch.float32] - cpu[torch.float64]).max())
    rounding = 5e-7
    tol_seq = (1e-5 + 2 * drift, 0.0)
    e_app = max_err(torch.as_tensor(served),
                    torch.as_tensor(cpu[torch.float64]),
                    (tol_seq[0] + rounding, 0.0))
    log(f"[rnn] served trajectories vs the port's SequencePredictor on the "
        f"CPU in f64: max|err| {e_app:.2e} (tol 1e-5 + 2 x {drift:.2e}, the "
        f"CPU f32 run's drift from f64, + {rounding:g} printing)")

    net = load_recurrent(ckpt, rnn_model(be, 0), be)
    wS, wX, b, w2, b2 = net.params
    frnn = FusedRNN(wX, wS, b, net.states[0], "logistic", impl="pallas")
    xs_dev = torch.as_tensor(xs, device=DEVICE)
    K.reset_launch_counts()
    ys = [frnn.seq_forward(x)[0] for x in xs_dev]
    torch.cuda.synchronize()
    launches = K.launch_counts()["fused_rnn_step"]
    check(launches == RNN_SEQS * RNN_N, f"FusedRNN(impl='pallas') over "
          f"{RNN_SEQS} x {RNN_N} steps launched fused_rnn_step {launches} "
          f"times")
    logistic = K._act_fn("logistic")
    rebuilt = torch.stack([logistic(logistic(y) @ w2.T + b2) for y in ys])
    e_k = max_err(rebuilt, torch.as_tensor(served),
                  (tol_seq[0] + rounding, 0.0))
    e_k64 = max_err(rebuilt, torch.as_tensor(cpu[torch.float64]), tol_seq)
    log(f"[rnn] FusedRNN(impl='pallas') from the served model's cell (params "
        f"0-2, state 0): {launches} fused_rnn_step launches for {RNN_SEQS} "
        f"sequences of {RNN_N}; logistic(logistic(ys) W2^T + b2) vs the "
        f"served trajectories max|err| {e_k:.2e}, vs the CPU f64 run "
        f"{e_k64:.2e} (tol as above)")

    # five SGD steps over the first RNN_TRAIN_N steps of sequence 0
    x_tr = xs[0][:RNN_TRAIN_N]
    m64 = FusedRNN(*(t.detach().double().cpu() for t in (wX, wS, b,
                                                         net.states[0])))
    ys64 = m64.seq_forward(x_tr)[0].numpy()
    tg = ys64 + 0.5 * np.random.default_rng(1).standard_normal(ys64.shape)
    models = {"pallas": frnn, "xla": FusedRNN(wX, wS, b, net.states[0]),
              "cpu f64": m64}
    losses = {k: [] for k in models}
    for _ in range(5):
        for k in models:
            v, models[k] = models[k].train(RNN_TRAIN_RATE, RNN_TRAIN_RATE,
                                           x_tr, tg)
            losses[k].append(v)
    torch.cuda.synchronize()
    check(losses["pallas"][-1] < losses["pallas"][0],
          f"FusedRNN(impl='pallas').train did not lower the loss: "
          f"{losses['pallas']}")
    check(models["pallas"].impl == "pallas", "train lost the impl")

    def params(m):
        return (m.wX, m.wS, m.b, m.s0)

    for ref in ("xla", "cpu f64"):
        e = max(max_err(a, c, TOL_5_STEPS) for a, c in
                zip(params(models["pallas"]), params(models[ref])))
        log(f"[rnn] 5 FusedRNN.train steps (rate {RNN_TRAIN_RATE:g}, "
            f"{RNN_TRAIN_N} steps of sequence 0), impl='pallas' vs {ref}: "
            f"max|err| {e:.2e} tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|;"
            f" losses {[round(v, 3) for v in losses['pallas']]}")

    # the sequence gradient with the tape on the card and in pinned host
    # memory: bit for bit
    loss = squared_error(RNN_OUT)
    tgt = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 1, size=(RNN_N, RNN_OUT)), dtype=torch.float32, device=DEVICE)
    args = (xs_dev[0],) + net.states + net.params + (tgt,)
    for remat in (None, 8):
        v_on, g_on = ir.value_and_grad(
            net._seq_graph(loss, RNN_N, remat_every=remat), be, args)
        v_off, g_off = ir.value_and_grad(
            net._seq_graph(loss, RNN_N, remat_every=remat,
                           offload_tape=True), be, args)
        torch.cuda.synchronize()
        check(torch.equal(v_on, v_off) and all(
            torch.equal(a, c) for a, c in zip(g_on, g_off)),
            f"offload_tape (remat_every={remat}) changed the sequence "
            f"gradient")
    scan = seq_scan_op(net.op, RNN_N, 1, None, True)
    _, tape = scan.apply_tape(be, args[:-1])
    torch.cuda.synchronize()
    host = tape[1].slices[0][0]
    check(host.device.type == "cpu" and host.is_pinned() and
          len(tape[1].slices) == RNN_N, "offload_tape did not tape to pinned "
          "host memory")
    log(f"[rnn] sequence gradient (n={RNN_N}) with offload_tape: "
        f"bit-identical to the on-device tape, plain and remat_every=8; "
        f"the {RNN_N} taped carries are pinned host tensors")
    return {"launches": launches, "net": net, "frnn": frnn, "be": be,
            "xs": xs_dev, "served_err": e_app}


def phase_rnn_timing(rs) -> dict:
    """Kernel 7 vs its plain version at B = 1 and 256, a FusedRNN
    sequence's wall time and launches, and SequencePredictor requests at
    buckets 8 and 256 (p50, and where a request's time goes)."""
    from tensor_ops_tpu_torch.models import SequencePredictor
    from tensor_ops_tpu_torch.ops import kernels as K

    times = {}
    with torch.inference_mode():
        for B in (1, 256):
            args = rnn_step_inputs(800 + B, B, RNN_IN, RNN_HIDDEN)
            k_ms = _median_ms(lambda: K._fused_rnn_step_cuda(*args,
                                                             "logistic"))
            p_ms = _median_ms(lambda: K.fused_rnn_step_ref(*args,
                                                           "logistic"))
            prof = _profile_steps(lambda: K._fused_rnn_step_cuda(
                *args, "logistic"))
            name = "rnn_step_gemv_kernel" if B == 1 else "rnn_step_gemm_kernel"
            check(list(prof["by_kernel"]) == [name], f"profiler saw "
                  f"{sorted(prof['by_kernel'])} for fused_rnn_step B={B}")
            bound = rnn_step_bound(B)
            log(f"[timing] fused_rnn_step B={B} {RNN_IN}->{RNN_HIDDEN} "
                f"logistic: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, device "
                f"{prof['busy_us']:.2f} us ({name}); bound "
                f"{bound[0] * 1e3:.3f} us by {bound[1]}")
            times[B] = (k_ms, p_ms, prof["busy_us"])

    frnn, xs = rs["frnn"], rs["xs"]
    for x in xs[:2]:
        frnn.seq_forward(x)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for x in xs:
        frnn.seq_forward(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / len(xs) * 1e3
    per_seq = K.launch_counts()["fused_rnn_step"] / len(xs)
    prof = _profile_steps(lambda: frnn.seq_forward(xs[0]), steps=4)
    log(f"[timing] FusedRNN(impl='pallas').seq_forward n={RNN_N}: "
        f"{wall_ms:.3f} ms/sequence wall, {per_seq:.0f} fused_rnn_step "
        f"launches/sequence; device busy {prof['busy_us']:.1f} us/sequence "
        f"in {prof['launches']:.0f} kernels, idle share "
        f"{1 - prof['busy_us'] / (wall_ms * 1e3):.3f}")

    sp = SequencePredictor(rs["net"], rs["be"], buckets=RNN_BUCKETS)
    sp.warmup([RNN_N])
    r = np.random.default_rng(9)
    for b in RNN_BUCKETS:
        x = r.standard_normal((b, RNN_N, RNN_IN)).astype(np.float32)
        sp.timer.samples.clear()
        for _ in range(20):
            sp.predict(x)
        p50 = sp.latency()["p50_s"] * 1e3
        prof = _profile_steps(lambda: sp.predict(x), steps=2)
        log(f"[timing] SequencePredictor bucket {b}, n={RNN_N}: p50 "
            f"{p50:.3f} ms host clock (n=20); device busy "
            f"{prof['busy_us'] / 1e3:.3f} ms/request in "
            f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} copies, "
            f"idle share {1 - prof['busy_us'] / (p50 * 1e3):.3f}; largest "
            f"(us/request): " + ", ".join(
                f"{n} {us:.1f}" for n, us in
                list(prof["by_kernel"].items())[:3]))
    return times


def _ring_call(phase: str, xs, route: str = "kernel", scale=None):
    """One collective over the per-rank tensors ``xs`` by ``route``:
    "kernel" the public wrapper (the one-shot when the ranks share a card;
    for rs with a scale, the one-shot directly), "plain" its plain version
    ``oneshot_ref``, "ring" the ring protocol called directly, "ring plain"
    the ring protocol's plain version."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as C

    one_way = phase == "one-way ar"
    p = "ar" if one_way else phase
    if route == "kernel":
        if p == "ar":
            fn = C.ring_all_reduce if one_way else C.ring_all_reduce_bidir
            return fn(xs, scale=scale)
        if scale is not None:
            return C._oneshot(xs, p, False, scale)
        return {"rs": C.ring_reduce_scatter, "ag": C.ring_all_gather}[p](xs)
    if route == "plain":
        return C.oneshot_ref(xs, p, one_way, scale)
    if route == "ring":
        return C._ring_cuda(xs, p, one_way)
    return C.ring_all_reduce_ref(xs) if one_way else C.bidir_ring_ref(xs, p)


def _ring_inputs(seed: int, devices, shape, dtype: str):
    """One tensor per rank, on that rank's device: int32 in [-1000, 1000)
    or f32 N(0, 1) from ``default_rng(seed)``."""
    r = np.random.default_rng(seed)
    n = len(devices)
    a = (r.integers(-1000, 1000, size=(n,) + shape).astype(np.int32)
         if dtype == "int32" else
         r.normal(size=(n,) + shape).astype(np.float32))
    return [torch.as_tensor(a[i], device=d) for i, d in enumerate(devices)]


def _same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.contiguous().view(torch.int32).cpu(),
                        b.contiguous().view(torch.int32).cpu())
        for a, b in zip(got, want))


def _ring_kernel_name(phase: str, route: str = "kernel") -> str:
    name = "ring_all_reduce" if phase == "one-way ar" else "bidir_ring"
    return name + ".ring" if route == "ring" else name


def _ring_cases(devices, seed: int, route: str):
    """Every phase against its plain version on the JAX tests' shapes (per
    rank) and the flagship's six parameter shapes, int32 and f32, bit for
    bit: route "kernel" (the wrappers) against ``oneshot_ref`` and the ring
    protocol's plain version, and, for f32 ar and rs, with the 1/R scale
    against ``oneshot_ref`` with it; route "ring" (the ring protocol called
    directly) against its plain version.  Returns the number of cases held
    and skipped (rs needs the leading axis divisible by R), and per kernel
    the largest |kernel - plain| seen (0 where every case is bit-equal)."""
    R = len(devices)
    shapes = [(R * 16, 128), (R * 8, 3, 7), (R * 8, 50), (R * 8,)]
    shapes += list(FLAGSHIP_PARAM_SHAPES)
    held = skipped = 0
    worst = {}
    for phase in RING_PHASES:
        name = _ring_kernel_name(phase, route)
        worst.setdefault(name, 0.0)
        for i, shape in enumerate(shapes):
            if phase == "rs" and shape[0] % R:
                skipped += 2
                continue
            for dtype in ("int32", "float32"):
                xs = _ring_inputs(seed + 10 * i, devices, shape, dtype)
                scales = [None]
                # the wrappers take a scale for ar; rs takes it from the
                # one-shot directly, which runs the ranks of one card
                if (route == "kernel" and dtype == "float32" and phase != "ag"
                        and (phase != "rs" or len(set(devices)) == 1)):
                    scales.append(1.0 / R)
                for scale in scales:
                    got = _ring_call(phase, xs, route, scale)
                    torch.cuda.synchronize()
                    wants = [_ring_call(phase, xs, "ring plain")]
                    if route == "kernel":
                        wants.insert(0, _ring_call(phase, xs, "plain", scale))
                        if scale is not None:
                            wants[1] = [t * scale for t in wants[1]]
                    worst[name] = max([worst[name]] + [
                        float((a.cpu().double() - b.cpu().double()).abs().max())
                        for a, b in zip(got, wants[0]) if a.numel()])
                    for want in wants:
                        check(_same_bits(got, want),
                              f"ring {phase} ({route}) R={R} {shape} {dtype} "
                              f"scale {scale} on {devices}: not bit-equal to "
                              f"its plain version")
                    held += 1
    return held, skipped, worst


# A second interpreter asks for what one card cannot run at once and must
# be refused, not hang: more ranks than one launch takes (ValueError before
# any launch, on both routes), and, with the wrapper told the card holds 4x
# the blocks it does, the ring protocol at 4 ranks of cap blocks each: it
# plans a grid the card cannot hold, and cudaLaunchCooperativeKernel must
# refuse it (RuntimeError).
CORESIDENCY_CHECK = r"""
import torch
from tensor_ops_tpu_torch.parallel import collective_kernels as C
cap = C.ring_capacity("bidir_ring", "cuda:0")
x = torch.zeros(8, device="cuda")
R = C.MAX_LOCAL_RANKS + 1
for route, call in (("one-shot", C.ring_all_reduce_bidir),
                    ("ring", lambda xs: C._ring_cuda(xs, "ar", False))):
    try:
        call([x] * R)
        raise SystemExit(f"R={R} ranks were not refused ({route})")
    except ValueError as e:
        print(f"[ring] {route} refused:", e)
C.ring_capacity = lambda lib, device: 4 * cap
# two pieces of cap * 512 elements per rank: cap blocks per rank
xs = [torch.zeros(4 * cap * C.CHUNK, device="cuda") for _ in range(4)]
try:
    C._ring_cuda(xs, "ar", False)
    torch.cuda.synchronize()
    raise SystemExit(f"4 ranks x {cap} blocks were not refused")
except RuntimeError as e:
    print("[ring] ring refused:", e)
print("[ring] card holds", cap, "blocks")
"""


def phase_ring_kernels() -> dict:
    """Kernels 8 and 9 on one card: the one-shot against its plain version
    (and the ring protocol's) at RING_RANKS ranks, with and without the
    1/R scale; the ring protocol, called directly, against its plain
    version at PROTOCOL_RANKS; two ring-protocol calls back to back on one
    scratch; rs then ag against ar on both routes; and the refusals, in a
    second interpreter with a time limit."""
    worst = {name: 0.0 for name in RING_NAMES}
    for route, ranks in (("kernel", RING_RANKS), ("ring", PROTOCOL_RANKS)):
        for R in ranks:
            held, skipped, errs = _ring_cases([DEVICE] * R, 1000 + 100 * R,
                                              route)
            for name, e in errs.items():
                worst[name] = max(worst[name], e)
            what = ("one-shot (the wrappers) vs oneshot_ref and the ring's "
                    "plain version, f32 ar/rs also with the 1/R scale"
                    if route == "kernel" else
                    "ring protocol (_ring_cuda) vs its plain version")
            log(f"[ring] R={R} ranks on one card, {what}: {held} cases "
                f"(one-way ar, bidirectional ar/rs/ag; int32 and f32 N(0,1); "
                f"the JAX tests' shapes and the flagship's six parameters) "
                f"bit-equal; {skipped} rs cases skipped (shape[0] not "
                f"divisible by R)")
    for phase in RING_PHASES:
        big = _ring_inputs(2000, [DEVICE] * 4, (300, 784), "float32")
        small = _ring_inputs(2001, [DEVICE] * 4, (100,), "float32")
        a = _ring_call(phase, big, "ring")
        b = _ring_call(phase, small, "ring")
        c = _ring_call(phase, big, "ring")
        torch.cuda.synchronize()
        check(_same_bits(a, c) and _same_bits(
            b, _ring_call(phase, small, "ring plain")),
            f"ring {phase}: calls back to back on one scratch differ")
    for R in RING_RANKS:
        xs = _ring_inputs(2100 + R, [DEVICE] * R, (R * 16, 128), "int32")
        routes = [("kernel", lambda p, v: _ring_call(p, v))]
        if R in PROTOCOL_RANKS:
            routes.append(("ring", lambda p, v: _ring_call(p, v, "ring")))
        for route, call in routes:
            check(_same_bits(call("ag", call("rs", xs)), call("ar", xs)),
                  f"rs then ag differs from ar at R={R} ({route})")
    log("[ring] ring protocol back to back on one scratch (300x784, 100, "
        "300x784) bit-equal in every phase; rs then ag == ar (int32) at "
        "R=2, 3, 4, 8 (one-shot) and 2, 4, 8 (ring protocol)")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", CORESIDENCY_CHECK], capture_output=True,
        text=True, timeout=300, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"co-residency check failed:\n"
          f"{proc.stdout}{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        log(line)
    return worst


def phase_ring_cross_card() -> None:
    """The wrappers at one rank per card (the ring protocol's route)
    against the ring's plain version, where the machine has several
    cards."""
    from tensor_ops_tpu_torch.parallel import RankGroup

    count = torch.cuda.device_count()
    if count < 2:
        log(f"[ring] cross-card ring not run: {count} card visible (it needs "
            f"two or more)")
        return
    group = RankGroup(count)  # one rank per card; peer access checked
    held, skipped, _ = _ring_cases([str(d) for d in group.devices], 4000,
                                   "kernel")
    log(f"[ring] cross-card: R={count} ranks, one per card: {held} cases "
        f"bit-equal to the plain versions ({skipped} rs cases skipped)")


def phase_dp_slice(tmp: str) -> dict:
    """The flagship at full width (gen_net, seed 0) for DP_STEPS steps of
    dp_megakernel_train_step over DP_RANKS ranks of DP_ROWS rows of the
    synthetic set, on each route (bidirectional ring, then one-way)."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (FusedMLP, act_logistic,
                                             act_softmax, gen_net)
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import (RankGroup,
                                               dp_megakernel_train_step)
    from tensor_ops_tpu_torch.utils.mnist_data import load_mnist

    with no_download(), contextlib.redirect_stdout(io.StringIO()):
        train_raw, _ = load_mnist(tempfile.mkdtemp(dir=tmp))
    B = DP_RANKS * DP_ROWS
    xb = np.stack([d / 255.0 for _, d in train_raw[:B]])
    yb = np.eye(10)[[l for l, _ in train_raw[:B]]]
    x32 = torch.as_tensor(xb, dtype=torch.float32, device=DEVICE)
    y32 = torch.as_tensor(yb, dtype=torch.float32, device=DEVICE)
    be = TorchBackend(torch.float32, DEVICE)
    net = gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                  [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                  act_softmax(), Rng(be, 0))
    fm = FusedMLP.from_network(net)
    ws0 = [w.float() for w in fm.weights]
    bs0 = [b.float() for b in fm.biases]
    acts = ("logistic", "logistic", "identity")
    group = RankGroup(DP_RANKS)
    cpu_group = RankGroup(devices=["cpu"] * DP_RANKS)
    out = {"group": group, "x": x32, "y": y32, "ws": ws0, "bs": bs0,
           "fm": fm}
    for bidirectional in (True, False):
        route = "bidir_ring" if bidirectional else "ring_all_reduce"
        other = "ring_all_reduce" if bidirectional else "bidir_ring"
        step = dp_megakernel_train_step(group, acts, lr=TRAIN_RATE,
                                        bidirectional=bidirectional)
        ws, bs, losses = ws0, bs0, []
        K.reset_launch_counts()
        for i in range(DP_STEPS):
            loss, ws, bs = step(x32, y32, ws, bs)
            if i == 0:
                first = (loss, ws, bs)
            r0 = step.replicas[0][0] + step.replicas[0][1]
            for r, (r_ws, r_bs) in enumerate(step.replicas[1:], 1):
                check(all(torch.equal(a, c) for a, c in zip(r0, r_ws + r_bs)),
                      f"dp {route}: rank {r}'s parameters differ from rank "
                      f"0's after step {i + 1}")
            losses.append(float(loss))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        # one one-shot launch per tensor; the ring protocol is the route of
        # ranks on several cards and runs no time here
        want = {"fused_mlp_train_step": DP_RANKS * DP_STEPS,
                route: 6 * DP_STEPS, other: 0, f"{route}.ring": 0,
                f"{other}.ring": 0}
        check(all(counts[k] == v for k, v in want.items()),
              f"dp {route}: launches {counts}, want {want}")
        check(losses[-1] < losses[0], f"dp {route}: the loss did not fall "
              f"({losses})")
        # one dp step against one step on the whole batch, on the card
        loss1, ws1, bs1 = K._fused_mlp_train_step_cuda(
            x32, y32, ws0, bs0, TRAIN_RATE, acts, "softmax_xent")
        torch.cuda.synchronize()
        e_loss = max_err(first[0], loss1, TOL_LOSS)
        e_par = max(max_err(a, c, TOL_PARAM) for a, c in
                    zip(first[1] + first[2], ws1 + bs1))
        # five steps against the plain dp step in CPU f64
        cpu_step = dp_megakernel_train_step(cpu_group, acts, lr=TRAIN_RATE,
                                            bidirectional=bidirectional)
        w64 = [w.double().cpu() for w in ws0]
        b64 = [b.double().cpu() for b in bs0]
        x64, y64 = torch.as_tensor(xb), torch.as_tensor(yb)
        for _ in range(DP_STEPS):
            _, w64, b64 = cpu_step(x64, y64, w64, b64)
        e5 = max(max_err(a, c, TOL_5_STEPS) for a, c in
                 zip(ws + bs, w64 + b64))
        log(f"[dp] {route}: {DP_STEPS} steps of dp_megakernel_train_step, "
            f"{DP_RANKS} ranks x {DP_ROWS} rows on "
            f"{sorted(set(map(str, group.devices)))}, "
            f"rate {TRAIN_RATE}: losses {[round(v, 5) for v in losses]}; "
            f"launches {counts}; ranks bit-identical after every step; step 1"
            f" vs fused_mlp_train_step on the {B}-row batch max|err| loss "
            f"{e_loss:.2e} (tol {TOL_LOSS[0]:g}+{TOL_LOSS[1]:g}|ref|), params "
            f"{e_par:.2e} (tol {TOL_PARAM[0]:g}+{TOL_PARAM[1]:g}|ref|); "
            f"{DP_STEPS} steps vs the plain dp step in CPU f64 max|err| "
            f"{e5:.2e} (tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|)")
        out[route] = {"launches": counts[route], "losses": losses,
                      "protocol launches": counts[f"{route}.ring"]}
    return out


def ring_bound(phase: str, R: int, shape):
    """(least ms, what bounds it) of one ring call on R ranks of one card,
    for the function and not the ring algorithm: every rank reads its input
    (``size`` f32 elements, the shard for ag) once and writes its output
    once (size for ar, size / R for rs, R * size for ag), and the sum
    takes (R - 1) adds per element reduced:
        bytes = 4 R (size + out)           over HBM_BPS,
        ops   = (R - 1) size for ar and rs over the f32 peak.
    The comm-slot traffic a ring adds is its own cost: ring_slot_ms."""
    p = "ar" if phase == "one-way ar" else phase
    size = math.prod(shape)
    out = {"ar": size, "rs": size // R, "ag": R * size}[p]
    adds = (R - 1) * size if p in ("ar", "rs") else 0
    return _bound(4 * R * (size + out), adds, "f32")


def ring_slot_ms(phase: str, R: int, shape) -> float:
    """The ring algorithm's own HBM traffic on one card, over HBM_BPS: at
    each of its n_steps steps every rank writes one padded chunk (D pieces
    of H f32 elements) into a neighbour's comm slot, which the neighbour
    reads back: 2 * 4 R n_steps D H bytes."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as C

    one_way = phase == "one-way ar"
    p = "ar" if one_way else phase
    D, H = C._layout(p, shape, R, one_way)[:2]
    n_steps = 2 * (R - 1) if p == "ar" else R - 1
    return 2 * 4 * R * n_steps * D * H / HBM_BPS * 1e3


def phase_dp_timing(dp) -> dict:
    """Each phase at the flagship's 300x784 weight on DP_RANKS ranks of one
    card: the one-shot's and one PyTorch call's CUDA-event medians and host
    time per call, taken in turns over 3 repetitions, the one-shot's plain
    version, the profiler's device time and the bound; the ring protocol
    called directly beside it; then a dp step's wall time, kernels, device
    busy time and idle share on each route, and samples/s beside a
    single-rank train_fullfused step on the whole batch."""
    times = {}
    shape = FLAGSHIP_PARAM_SHAPES[0]
    xs = _ring_inputs(3000, [DEVICE] * DP_RANKS, shape, "float32")
    library = {"one-way ar": lambda: torch.stack(xs).sum(0),
               "ar": lambda: torch.stack(xs).sum(0),
               # every rank's block at once
               "rs": lambda: torch.stack(xs).sum(0),
               "ag": lambda: torch.cat(xs)}
    from tensor_ops_tpu_torch.parallel import collective_kernels as C

    wrapper = {"one-way ar": C.ring_all_reduce,
               "ar": C.ring_all_reduce_bidir, "rs": C.ring_reduce_scatter,
               "ag": C.ring_all_gather}
    for phase in RING_PHASES:
        name = _ring_kernel_name(phase)
        reps = []
        fn = wrapper[phase]
        for _ in range(3):
            reps.append((_median_ms(lambda: fn(xs)),
                         _median_ms(library[phase]),
                         _host_us(lambda: fn(xs)),
                         _host_us(library[phase])))
        k_ms, l_ms, k_us, l_us = (statistics.median(rep[i] for rep in reps)
                                  for i in range(4))
        p_ms = _median_ms(lambda: _ring_call(phase, xs, "plain"))
        prof = _profile_steps(lambda: fn(xs))
        dev_us = _per_launch_us(prof, f"{name}_oneshot_kernel")
        check(dev_us > 0, f"the profiler saw {prof['calls']} for the "
              f"one-shot {phase}")
        r_ms = _median_ms(lambda: _ring_call(phase, xs, "ring"))
        rp_ms = _median_ms(lambda: _ring_call(phase, xs, "ring plain"))
        rprof = _profile_steps(lambda: _ring_call(phase, xs, "ring"))
        ring_us = _per_launch_us(rprof, f"{name}_kernel")
        check(ring_us > 0, f"the profiler saw {sorted(rprof['by_kernel'])} "
              f"for the ring protocol {phase}")
        least = ring_bound(phase, DP_RANKS, shape)
        log(f"[timing] {phase} ({name}) R={DP_RANKS} on one card, "
            f"{'x'.join(map(str, shape))} f32 per rank: one-shot device "
            f"{dev_us:.2f} us ({dev_us / (least[0] * 1e3):.2f}x the bound "
            f"{least[0] * 1e3:.3f} us by {least[1]}), {prof['launches']:.0f} "
            f"kernels + {prof['copies']:.0f} copies per call; events, in "
            f"turns over 3 repetitions, one-shot "
            f"{', '.join(f'{rep[0]:.4f}' for rep in reps)} ms vs library "
            f"{', '.join(f'{rep[1]:.4f}' for rep in reps)} ms (medians "
            f"{k_ms:.4f} vs {l_ms:.4f}); host clock per call, in the same "
            f"turns, one-shot {', '.join(f'{rep[2]:.2f}' for rep in reps)} "
            f"us vs library {', '.join(f'{rep[3]:.2f}' for rep in reps)} us "
            f"(medians {k_us:.2f} vs {l_us:.2f}); plain {p_ms:.4f} ms")
        log(f"[timing] {phase} ring protocol (_ring_cuda) R={DP_RANKS} on "
            f"one card: device {ring_us:.2f} us in {rprof['launches']:.0f} "
            f"kernels + {rprof['copies']:.0f} copies, events {r_ms:.4f} ms, "
            f"plain {rp_ms:.4f} ms; its comm-slot traffic "
            f"{ring_slot_ms(phase, DP_RANKS, shape) * 1e3:.3f} us beyond the "
            f"bound")
        if phase in ("one-way ar", "ar"):
            times[name] = (k_ms, p_ms, l_ms, dev_us)
            times[f"{name}.ring"] = (r_ms, rp_ms, l_ms, ring_us)

    from tensor_ops_tpu_torch.parallel import dp_megakernel_train_step

    acts = ("logistic", "logistic", "identity")
    x, y, ws, bs = dp["x"], dp["y"], dp["ws"], dp["bs"]
    routes = {r: dp_megakernel_train_step(
        dp["group"], acts, lr=TRAIN_RATE, bidirectional=(r == "bidir_ring"))
        for r in ("bidir_ring", "ring_all_reduce")}
    routes = {f"dp step, {r}": (r, lambda s=s: s(x, y, ws, bs))
              for r, s in routes.items()}
    routes[f"single rank train_fullfused, B={len(x)}"] = (
        None, lambda: dp["fm"].train_fullfused(TRAIN_RATE, x, y))
    for name, (ring, step) in routes.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / 20 * 1e6
        prof = _profile_steps(step)
        top = ", ".join(f"{n} {us:.1f}" for n, us in
                        list(prof["by_kernel"].items())[:4])
        extra = ""
        if ring is not None:
            # the profiler's count (the wrappers' counters hold the exact
            # launches in the dp slice phase; the profiler may drop an event)
            ones = prof["calls"].get(f"{ring}_oneshot_kernel", 0)
            elementwise = sum(c for n, c in prof["calls"].items()
                              if "elementwise" in n)
            check(ones > 0, f"{name}: the profiler saw no one-shot launch")
            extra = (f"; {ones:.1f} one-shot launches per step (the 1/n "
                     f"inside them), {elementwise:.1f} elementwise kernels "
                     f"(the loss's sum and 1/n), no parameter multiplies; "
                     f"want {DP_KERNELS_PER_STEP} kernels and 6 one-shot "
                     f"launches per step")
        log(f"[timing] {name}: {wall_us:.1f} us/step wall, "
            f"{len(x) / (wall_us * 1e-6):.0f} samples/s, "
            f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} "
            f"copies/step, device busy {prof['busy_us']:.1f} us/step, idle "
            f"share {1 - prof['busy_us'] / wall_us:.3f}; largest (us/step): "
            f"{top}{extra}")
    return times


def _bound(nbytes: float, ops: float, kind: str):
    """(least ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def bounds() -> dict:
    """Each kernel's bound at the shape its time is taken at: each input
    read once, each output written once, the operations its inputs need."""
    layers = list(zip(FLAGSHIP[:-1], FLAGSHIP[1:]))  # (K, O)
    kos = sum(k * o for k, o in layers)
    params = kos + sum(o for _, o in layers)

    def per_layer(B, x_bytes, w_bytes, n_vectors, kind):
        parts = [_bound(B * k * x_bytes + o * k * w_bytes
                        + n_vectors * o * 4 + B * o * 4, 2 * B * k * o, kind)
                 for k, o in layers]
        return (sum(ms for ms, _ in parts),
                max(parts, key=lambda p: p[0])[1])

    B, T = 8, 100
    n, L, Bs = STACK_N, STACK_L, STACK_B
    k, o = layers[-1]
    return {
        # the flagship's identity layer (100 -> 10) at B=8
        "fused_linear": _bound(4 * (B * k + o * k + o + B * o), 2 * B * k * o,
                               "f32"),
        "fused_mlp_forward": _bound(
            4 * (B * FLAGSHIP[0] + params + B * FLAGSHIP[-1]),
            2 * B * kos, "f32"),
        # B=100: x, one-hot y, the parameters read and written, the loss;
        # forward, weight gradients and all but the first input gradient
        "fused_mlp_train_step": _bound(
            4 * (T * FLAGSHIP[0] + T * FLAGSHIP[-1] + 2 * params + 1),
            2 * T * (2 * kos + kos - layers[0][0] * layers[0][1]), "f32"),
        # int8 codes, f32 scale and bias; w8's products are bf16 at default
        "fused_linear_w8": per_layer(B, 4, 1, 2, "bf16"),
        "fused_linear_w8a8": per_layer(B, 4, 1, 2, "int8"),
        "fused_mlp_w8a8_forward": _bound(
            Bs * n * 4 + L * n * n + 2 * L * n * 4 + Bs * n * 4,
            2 * L * Bs * n * n, "int8"),
        # FusedRNN's per-timestep launch: B=1 at 32 -> 512
        "fused_rnn_step": rnn_step_bound(1),
        # the flagship's 300x784 weight over the dp slice's ranks, on
        # either route: the function's bytes, whatever the algorithm
        "ring_all_reduce": ring_bound("one-way ar", DP_RANKS,
                                      FLAGSHIP_PARAM_SHAPES[0]),
        "bidir_ring": ring_bound("ar", DP_RANKS, FLAGSHIP_PARAM_SHAPES[0]),
        "ring_all_reduce.ring": ring_bound("one-way ar", DP_RANKS,
                                           FLAGSHIP_PARAM_SHAPES[0]),
        "bidir_ring.ring": ring_bound("ar", DP_RANKS,
                                      FLAGSHIP_PARAM_SHAPES[0]),
    }


def rnn_step_bound(B: int):
    """Kernel 7 at the recurrent slice's widths: x, s, Wx, Ws and b read,
    y and s' written, 2 B (I + O) O f32 operations."""
    I, O = RNN_IN, RNN_HIDDEN
    return _bound(4 * (B * I + B * O + O * I + O * O + O + 2 * B * O),
                  2 * B * (I + O) * O, "f32")


def timed(name: str, fn, *args):
    """``fn(*args)``, logging the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    name, card = phase_environment()
    timed("build", phase_build)
    worst = timed("kernels 1-3", phase_kernels)
    qm, weights, xs = timed("4x4096 stack on the CPU", int8_stack_cpu)
    stack = {"model": qm, "weights": weights, "x": xs}
    worst.update(timed("int8 kernels", phase_int8_kernels, stack))
    worst["fused_rnn_step"] = timed("recurrent kernel", phase_rnn_kernels)
    worst.update(timed("ring kernels", phase_ring_kernels))
    timed("cross-card ring", phase_ring_cross_card)
    with tempfile.TemporaryDirectory() as tmp:
        sl = timed("serving slice", phase_slice, tmp)
        sv = timed("int8 serving", phase_int8_serving, tmp, sl["ckpt"],
                   stack)
        tr = timed("training slice", phase_train, tmp)
        rs = timed("recurrent slice", phase_rnn_slice, tmp)
        dp = timed("data-parallel slice", phase_dp_slice, tmp)
    times = timed("serving timing", phase_timing, sl["model"])
    times.update(timed("int8 timing", phase_int8_timing, sv, stack))
    timed("training routes", phase_train_routes)
    times["fused_rnn_step"] = timed("recurrent timing", phase_rnn_timing,
                                    rs)[1]
    times.update(timed("data-parallel timing", phase_dp_timing, dp))
    for route in ("fused", "minibatch"):
        log(f"[timing] mnist app --minibatch 100{' --fused' * (route == 'fused')}"
            f": {tr[route]['samples_per_s']:.0f} training samples/s "
            f"(host clock, batches 2-6, the app's --metrics record)")
    # each kernel's launches are those of the path it serves: the serving
    # slice for the two forward kernels, the --fused mnist run for the step,
    # the int8 serve app's route for each int8 kernel, FusedRNN over the
    # served sequences for the Elman step
    launches = dict(sl["launches"])
    launches["fused_mlp_train_step"] = (
        tr["fused"]["launches"]["fused_mlp_train_step"])
    launches.update(sv["launches"])
    launches["fused_rnn_step"] = rs["launches"]
    # the dp slice's DP_STEPS steps on each ring's route: the one-shot's
    # launches, and the ring protocol's (the route of ranks on several
    # cards: 0 on one card)
    for n in ("ring_all_reduce", "bidir_ring"):
        launches[n] = dp[n]["launches"]
        launches[f"{n}.ring"] = dp[n]["protocol launches"]
    least = bounds()
    for n in KERNELS:
        log(f"[bound] {n}: {least[n][0]:.6f} ms by {least[n][1]} (H100 SXM "
            f"peaks: {HBM_BPS / 1e12:g} TB/s, {PEAK_OPS})")
    b256 = rnn_step_bound(256)
    log(f"[bound] fused_rnn_step at B=256: {b256[0]:.6f} ms by {b256[1]}")
    # library_ms: torch.addmm for kernel 1's identity layer and
    # torch.stack(xs).sum(0) for the collectives' all-reduce; no single PyTorch
    # call computes the others with their epilogues (activation, softmax,
    # SGD update, int8 rescale, both y and act(z)), so null
    kernels = [dict(name=n, **KERNELS[n], launches=launches[n],
                    max_abs_err=worst[n], ms=times[n][0],
                    plain_ms=times[n][1], bound_ms=least[n][0],
                    bound_by=least[n][1],
                    library_ms=times[n][2] if n in (
                        "fused_linear",) + RING_NAMES else None)
               for n in KERNELS]
    log(f"[card] every time above was taken on: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
