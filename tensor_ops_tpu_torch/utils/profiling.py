"""Step timing, device traces, NaN checks, cost and memory analysis
(SURVEY.md §5; the JAX package's ``utils/profiling.py``).

The reference's only instrumentation is a wall-clock ``time`` helper with
deepseq forcing (``app/Dots.hs:158-166``).  The port keeps the JAX
package's tools and return dicts, each written the PyTorch way:

* :class:`StepTimer`: CUDA work is asynchronous, so ``stop(result)``
  synchronises the result's device before it reads the clock;
* :func:`device_trace`: ``torch.profiler`` (CPU and, with a card, CUDA
  activity), a trace file TensorBoard and Perfetto read;
* :func:`enable_nan_checks`: a ``TorchDispatchMode`` that checks every
  op's floating output, as ``jax_debug_nans`` does, and the kernel
  wrappers' own checks of the hand-written kernels' outputs;
* :func:`cost_analysis` / :func:`memory_analysis`: a counting dispatch
  mode and ``torch.cuda``'s memory statistics in place of XLA's compiled
  analyses;
* :func:`measure_loop` / :func:`profile_step`: the differential method;
* :func:`training_memory_report`: the analytic per-device bytes of
  ``fit``'s training state.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
import weakref
from typing import Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import kernels as _kernels


def _sync(result) -> None:
    """Wait for every CUDA tensor in ``result`` (a tensor or a nest of
    tuples/lists/dicts of them) to be computed."""
    for d in {t.device for t in _kernels._tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Trace what runs inside with ``torch.profiler`` (the CPU and, when a
    card is visible, the CUDA activity) and write one trace file under
    ``logdir`` (``<host>_<pid>.<ms>.pt.trace.json``: TensorBoard's PyTorch
    profiler plugin and Perfetto read it).  The card is synchronised before
    the trace stops, so the kernels launched inside are in it.  One trace
    at a time; another may start after this one closes."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()


class StepTimer:
    """Per-step wall timing with device sync; reports p50/p90/mean.

    Thread-safe for concurrent start/stop pairs (each thread times its
    own request — N predict threads sharing one ``Predictor``): the
    in-flight start mark is thread-local, and the samples append is
    atomic under the GIL."""

    def __init__(self):
        self.samples: List[float] = []
        self._tl = threading.local()

    def start(self):
        self._tl.t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            _sync(result)
        t0 = getattr(self._tl, "t0", None)
        if t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self.samples.append(time.perf_counter() - t0)
        self._tl.t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        out = {}
        try:
            yield out
        finally:
            self.stop(out.get("result"))

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "n": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(0.9 * n))],
            "total_s": sum(s),
        }


# ---------------------------------------------------------------------------
# NaN checks
# ---------------------------------------------------------------------------

# ops whose output is uninitialised memory (nothing computed it yet)
_FACTORY = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "empty_permuted"})
# ops that place values without computing them (a tensor made from data, a
# copy, an assignment): a NaN they carry was made elsewhere or given
_PLACES = frozenset({"lift_fresh_copy", "_to_copy", "copy", "copy_",
                     "clone", "_copy_from", "_copy_from_and_resize", "fill",
                     "fill_", "index_put", "index_put_"})


class _NanCheckMode(TorchDispatchMode):
    """Every computing op's floating output checked for NaN: the first that
    holds one raises ``FloatingPointError`` naming the op
    (``jax_debug_nans``).  Views, allocations and ops that only place values
    (a tensor made from data, a copy) are not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not (name in _FACTORY or name in _PLACES or func.is_view):
            for t in _kernels._tensors(out):
                if ((t.is_floating_point() or t.is_complex())
                        and t.device.type != "meta" and t.numel()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


_nan_mode = None


def enable_nan_checks(enable: bool = True) -> None:
    """NaN debugging, the port of ``jax_debug_nans`` (the numerical analog of
    the race detection the reference gets for free from purity, SURVEY.md
    §5): while it is on, the first op whose floating output holds a NaN
    raises ``FloatingPointError`` naming the op, in the forward and in
    autograd's backward (its device threads inherit the check).  A
    hand-written kernel, launched through ctypes, is no op the check sees:
    its wrapper checks the kernel's outputs and raises naming the kernel.
    Every check synchronises with the card.  ``fit`` and ``fit_sequences``
    run unchained while it is on (a step captured in a CUDA graph cannot
    synchronise).  Turn it on and off from the same thread, outside any
    other dispatch mode."""
    global _nan_mode
    if enable and _nan_mode is None:
        _nan_mode = _NanCheckMode()
        _nan_mode.__enter__()
    elif not enable and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)
    _kernels._nan_checks = bool(enable)


def nan_checks_enabled() -> bool:
    """Whether :func:`enable_nan_checks` is on (the counterpart of reading
    ``jax.config.jax_debug_nans``)."""
    return _kernels.nan_checks_enabled()


# ---------------------------------------------------------------------------
# Cost and memory analysis
# ---------------------------------------------------------------------------

# one transcendental per output element (XLA's count for tanh)
_TRANSCENDENTAL = frozenset({"exp", "exp2", "expm1", "log", "log1p", "log2",
                             "log10", "tanh", "sigmoid", "_softmax",
                             "_log_softmax"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CountingMode(TorchDispatchMode):
    """Counts the work of every op that runs inside: products by
    ``torch.utils.flop_counter``'s formulas, transcendentals, and bytes (an
    op's tensor operands read once and its results written once; views and
    allocations move none).  With ``track``, the live bytes of the tensors
    the ops allocate, and their peak.  The kernel wrappers report a
    hand-written kernel's work through :meth:`add` or by running its plain
    version on meta tensors under this mode."""

    def __init__(self, track: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = self.transcendentals = self.bytes = 0
        self.track, self.live, self.peak = track, 0, 0
        self._owned = {}
        self._lock = threading.Lock()

    def add(self, flops, transcendentals, nbytes) -> None:
        with self._lock:
            self.flops += flops
            self.transcendentals += transcendentals
            self.bytes += nbytes

    def _allocated(self, outs, ins) -> None:
        held = {t.untyped_storage().data_ptr() for t in ins
                if t.device.type != "meta"}
        for t in outs:
            if t.device.type == "meta":
                continue
            st = t.untyped_storage()
            ptr = st.data_ptr()
            if ptr == 0 or ptr in held or ptr in self._owned:
                continue
            self._owned[ptr] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._freed, ptr)

    def _freed(self, ptr) -> None:
        with self._lock:
            self.live -= self._owned.pop(ptr, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = _kernels._tensors(out)
        ins = _kernels._tensors(args) + _kernels._tensors(kwargs)
        with self._lock:
            if self.track:
                self._allocated(outs, ins)
            if name in _FACTORY or func.is_view:
                return out
            formula = self._formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


@contextlib.contextmanager
def _counting(mode: _CountingMode):
    """``mode`` counting everything inside, the kernel wrappers' reports
    included."""
    prev = _kernels._cost_mode
    _kernels._cost_mode = mode
    try:
        with mode:
            yield mode
    finally:
        _kernels._cost_mode = prev


def cost_analysis(fn, *args) -> dict:
    """Run ``fn(*args)`` once and count its work, with XLA's key names (as
    :func:`profile_step` reads them): ``flops`` (the products, 2·M·N·K a
    matrix product, by ``torch.utils.flop_counter``'s formulas),
    ``transcendentals`` (one per output element of exp, log, tanh, sigmoid
    and softmax) and ``bytes accessed`` (each op's operands read once and
    its result written once).  A hand-written kernel counts the work of its
    plain version's math (its wrapper runs that on meta tensors of the same
    shapes), so a step through a kernel on the card counts what its plain
    version counts on the CPU.  The engine's compiled calls run direct
    under the counting mode, so a graph's work counts as its function's.
    Unlike XLA, which also counts one flop per
    element of elementwise arithmetic, only products count as flops."""
    with _counting(_CountingMode()) as mode:
        fn(*args)
    return {"flops": float(mode.flops),
            "transcendentals": float(mode.transcendentals),
            "bytes accessed": float(mode.bytes)}


def _scalar_sync(carry) -> None:
    """Synchronise by reading one scalar of ``carry`` (every card's stream
    when it holds no tensor)."""
    leaves = _kernels._tensors(carry)
    if leaves:
        float(leaves[0].reshape(-1)[0])
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_loop(step, init, steps=(50, 250), reps: int = 6,
                 args: tuple = ()) -> dict:
    """Steady-state seconds per iteration of ``carry = step(carry, *args)``
    by the differential method (BENCH.md): the loop runs ``lo`` and ``hi``
    iterations on the host, each run ended by reading one scalar of the
    carry (a synchronise); (best wall at hi - best wall at lo) / (hi - lo)
    removes the constant cost of the start and the synchronise.  The port
    has no ``fori_loop``: every iteration is launched from Python, so the
    host's launch cost is part of a step (as it is on the main path).
    Returns ``per_step_s`` and ``steps_per_s``."""
    lo_n, hi_n = steps

    def run(n):
        c = init
        for _ in range(n):
            c = step(c, *args)
        _scalar_sync(c)

    run(lo_n)
    run(hi_n)

    def wall(n):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run(n)
            best = min(best, time.perf_counter() - t0)
        return best

    per_step = (wall(hi_n) - wall(lo_n)) / (hi_n - lo_n)
    return {"per_step_s": per_step, "steps_per_s": 1.0 / per_step}


def profile_step(step, init, steps=(50, 250), reps: int = 6,
                 args: tuple = ()) -> dict:
    """:func:`measure_loop` plus :func:`cost_analysis` of ONE step: the
    achieved TFLOP/s and GB/s against the counted work.

        stats = profile_step(lambda c: train_step(c), carry0)
        # {'per_step_s', 'steps_per_s', 'flops', 'bytes_accessed',
        #  'tflops_per_s', 'gbytes_per_s', 'compile_s'}

    ``compile_s`` is the time of the counted first call, which runs direct
    (a kernel's first call builds it); a compiled call captures its CUDA
    graph in the loop's first, untimed runs."""
    t0 = time.perf_counter()
    ca = cost_analysis(step, init, *args)
    compile_s = time.perf_counter() - t0
    out = measure_loop(step, init, steps, reps, args=args)
    out["compile_s"] = compile_s
    flops, byts = ca["flops"], ca["bytes accessed"]
    out["flops"] = flops
    out["bytes_accessed"] = byts
    if flops:
        out["tflops_per_s"] = flops / out["per_step_s"] / 1e12
    if byts:
        out["gbytes_per_s"] = byts / out["per_step_s"] / 1e9
    return out


def _distinct(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def memory_analysis(fn, *args) -> dict:
    """The bytes of one call ``fn(*args)`` (the JAX package's keys):
    ``argument_size_in_bytes`` (the tensors passed in), ``output_size_in_
    bytes`` (the tensors returned), ``alias_size_in_bytes`` (the outputs
    that share storage with an argument), ``temp_size_in_bytes`` and
    ``total_in_bytes`` (argument + output + temp - alias).  temp: with an
    argument on a card, the peak of ``torch.cuda.max_memory_allocated``
    during the call (after ``reset_peak_memory_stats``) above what was
    allocated when it began (the arguments among it) and the outputs it
    leaves; on the CPU, the peak of the live bytes of the tensors the ops
    allocate during the call (a dispatch mode tracks them) less the outputs.
    Both read the whole process.  ``generated_code_size_in_bytes`` is left
    out: nothing is compiled per call (the kernels' code is built once into
    shared libraries).  The engine's compiled calls inside run direct
    (``engine.direct``), so temp counts what the function allocates, not a
    graph's replay into memory it already holds."""
    from .. import engine

    arg_ts = _distinct(_kernels._tensors(args))
    cards = sorted({t.device for t in arg_ts if t.is_cuda},
                   key=lambda d: d.index or 0)
    if cards:
        dev = cards[0]
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with engine.direct():
            out = fn(*args)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        with _counting(_CountingMode(track=True)) as mode:
            out = fn(*args)
        base, peak = 0, mode.peak
    out_ts = _distinct(_kernels._tensors(out))
    held = {t.untyped_storage().data_ptr() for t in arg_ts}
    arg_b = sum(map(_nbytes, arg_ts))
    out_b = sum(map(_nbytes, out_ts))
    alias_b = sum(_nbytes(t) for t in out_ts
                  if t.untyped_storage().data_ptr() in held)
    temp_b = max(0, peak - base - (out_b - alias_b))
    return {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
            "alias_size_in_bytes": alias_b, "temp_size_in_bytes": temp_b,
            "total_in_bytes": arg_b + out_b + temp_b - alias_b}


def training_memory_report(net, optimizer=None, batch_size: int = 128,
                           mesh=None, shard_opt_state: bool = False,
                           zero_stage: int = None,
                           mixed_precision: bool = False,
                           offload_opt_state: bool = False) -> dict:
    """Analytic bytes per device of ``fit``'s training state for its mesh,
    optimizer, ZeRO and offload options (the JAX package's report).

    Rows: params, gradients (transient in a step, a param's size and
    spec), optimizer moments (0 buffers for sgd, 1 for momentum, 2 for
    adam; ``adam8bit``'s int8 codes and per-block scales from its
    ``(n_blocks, block)`` layout), the bf16 compute copy under
    ``mixed_precision`` and one batch's input rows.  Each row follows the
    rules ``fit`` places by: ``param_specs`` on the mesh, then the ZeRO
    dim-choice rule (the first spec-free dimension the data-axis size dp
    divides) for ZeRO-1 moments (``shard_opt_state`` or ``zero_stage`` >=
    1), ZeRO-2 gradients and ZeRO-3 params; a leaf with no such dimension
    stays whole.  ``adam8bit``'s codes and scales follow the rule on their
    own shapes.  ``offload_opt_state=True`` moves the moment bytes into
    ``optimizer_host_bytes`` (pinned host memory between steps).  The step
    counters of adam are not counted.

    The params and moment rows are what a rank holds between steps: the
    sum of its shards' bytes in a run.  The JAX package's report skips
    ``param_specs`` when the model axis is 1 and so divides a
    row-parallel bias by dp, which its ``fit`` keeps whole; here the
    ``MODEL_AXIS`` entry counts, as it does in placement."""
    import math

    from ..models.optim import moment_footprint
    from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, extend_spec,
                                 param_specs)

    if zero_stage is None:
        zero_stage = 1 if shard_opt_state else 0
    shard_opt_state = shard_opt_state or zero_stage >= 1
    dtype_bytes = _itemsize(net.params[0])
    tp = dp = 1
    specs = [None] * len(net.param_stack)
    if mesh is not None:
        tp = mesh.shape.get(MODEL_AXIS, 1)
        dp = mesh.shape.get(DATA_AXIS, 1)
        specs = param_specs(net.param_stack, mesh)

    def local(shape, spec, zero: bool) -> int:
        """Elements a device holds of a leaf of ``shape`` on ``spec``,
        extended by the data axis when ``zero``."""
        spec = tuple(spec or (None,) * len(shape))
        n = math.prod(shape)
        for ax, s in enumerate(spec):
            if s == MODEL_AXIS and shape[ax] % tp == 0:
                n //= tp
        if zero and extend_spec(spec, shape, dp) is not None:
            n //= dp
        return n

    n_moments = 0
    if optimizer is not None and optimizer.name != "sgd":
        n_moments = 1 if optimizer.name == "momentum" else 2
    params_b = grads_b = moments_b = 0
    for shp, spec in zip(net.param_stack, specs):
        shp = tuple(shp)
        params_b += local(shp, spec, zero_stage >= 3) * dtype_bytes
        grads_b += local(shp, spec, zero_stage >= 2) * dtype_bytes
        if optimizer is not None and optimizer.name == "adam8bit":
            blk = optimizer.hyper[3] if optimizer.hyper else 256
            nb = -(-math.prod(shp) // blk)
            codes = local((nb, blk), None, shard_opt_state)
            scales = local((nb, 1), None, shard_opt_state)
            moments_b += 2 * (codes + scales * dtype_bytes)
        else:
            moments_b += int(moment_footprint(optimizer, dtype_bytes)
                             * local(shp, spec, shard_opt_state))
    compute_b = (params_b // dtype_bytes) * 2 if mixed_precision else 0
    in_elems = math.prod(net.op.in_stack[0])
    batch_b = (batch_size // max(dp, 1)) * in_elems * dtype_bytes
    moments_host_b = 0
    if offload_opt_state:
        moments_host_b, moments_b = moments_b, 0
    total = params_b + grads_b + moments_b + compute_b + batch_b
    return {
        "per_device": {
            "params_bytes": params_b,
            "grads_bytes": grads_b,
            "optimizer_bytes": moments_b,
            "optimizer_host_bytes": moments_host_b,
            "bf16_compute_copy_bytes": compute_b,
            "batch_bytes": batch_b,
            "training_state_total_bytes": total,
        },
        "mesh": {"dp": dp, "tp": tp},
        "zero1": bool(shard_opt_state and dp > 1),
        "zero_stage": zero_stage if dp > 1 else 0,
        "offload_opt_state": bool(offload_opt_state),
        "n_moment_buffers": n_moments,
    }


def _itemsize(x) -> int:
    import numpy as np

    if hasattr(x, "element_size"):
        return x.element_size()
    return np.dtype(x.dtype).itemsize
