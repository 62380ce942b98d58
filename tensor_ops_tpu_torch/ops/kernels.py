"""The port's kernels, each written by hand in CUDA C++ for Hopper and kept
beside its plain PyTorch version.

* :func:`fused_linear` — ``act(x @ w.T + b)`` (``csrc/fused_linear.cu``),
  the port of the TPU kernel ``_linear_act_kernel``, for f32 operands or,
  with bf16 ``x``, bf16 operands and y (f32 accumulation), with its
  backward in plain PyTorch as the JAX package's backward is plain XLA.
  :func:`linear_plan` picks one of its three instances per shape.
* :func:`fused_mlp_forward` — a whole ffLayer chain with an optional
  softmax output in one launch of a thread block cluster per batch tile
  (``csrc/fused_mlp_forward.cu``; :func:`mlp_forward_plan` sizes it), the
  port of the TPU kernel ``_mlp_kernel``.
* :func:`fused_mlp_train_step` — one whole SGD step (forward, loss,
  backward, update) in one cooperative launch whose stages
  (:func:`train_stages`) each spread over the whole card
  (``csrc/fused_mlp_train_step.cu``), the port of the TPU kernel
  ``_mlp_train_kernel``.
* :func:`fused_linear_w8` — weight-only int8 ``act(x @ (q * s).T + b)``
  (``csrc/fused_linear_w8.cu``), the port of ``_linear_w8_kernel``;
  :func:`w8_plan` picks one of its three instances (a gemv, a bf16
  tensor-core tile, an fp32 SIMT tile) and a split of K per shape.
* :func:`fused_linear_w8a8` — int8 x int8 -> int32 ``act((q(x) @ q.T) * sx
  * sw.T + b)`` (``csrc/fused_linear_w8a8.cu``), the port of
  ``_linear_w8a8_kernel``, on the int8 tensor cores, its row quantizer
  under programmatic dependent launch or, at B <= 8, inside the product's
  one launch (:func:`w8a8_plan`).
* :func:`fused_mlp_w8a8_forward` — a whole uniform-width int8 MLP in one
  cooperative launch on the int8 tensor cores, its weights streamed
  through a ring of stages across layer boundaries
  (``csrc/fused_mlp_w8a8_forward.cu``; :func:`mlp_w8a8_plan` sizes it),
  the port of ``_mlp_w8a8_kernel``.
* :func:`fused_rnn_step` — one Elman step ``z = x @ wx.T + s @ ws.T + b``,
  ``(y, s') = (z, act(z))`` (``csrc/fused_rnn_step.cu``), the port of
  ``_rnn_step_kernel``, with its backward in plain PyTorch as the JAX
  package's VJP is plain XLA; and :func:`fused_rnn_seq`, a whole sequence
  of such steps in one launch of a thread block cluster that keeps the
  weights on chip (:func:`rnn_seq_plan`), with plain BPTT as its backward.

The quantizers :func:`quantize_weights_int8` and :func:`quantize_acts_int8`
are plain PyTorch on every device, as the JAX package leaves them to XLA.

A wrapper takes its plain version (``*_ref``) only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises: no fallback.  Each
wrapper counts its launches (:func:`launch_counts`), so a run can show that
its main path went through the kernels.

Precision: the f32 kernels compute in IEEE fp32 FMA for both precision
names.  On the TPU, ``"default"`` meant bf16 multiplies on the MXU; the
argument is kept (and validated) so that callers and checkpoints carry
over.  ``fused_linear_w8`` is the exception: its TPU body rounds x and the
dequantized weight to bf16 at ``"default"``, so both its versions do.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

ACT_CODES = {"identity": 0, "logistic": 1, "relu": 2, "tanh": 3}
PRECISIONS = ("default", "highest")
MAX_SMEM_BYTES = 227 * 1024  # dynamic shared memory one H100 block may use
MAX_LAYERS = 16              # whole-chain kernels: layers in one launch
LOSS_KINDS = {"softmax_xent": 0, "squared_error": 1}
H100_SMS = 132               # streaming multiprocessors of one H100

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {"fused_linear": 0, "fused_mlp_forward": 0,
                             "fused_mlp_train_step": 0, "fused_linear_w8": 0,
                             "fused_linear_w8a8": 0,
                             "fused_mlp_w8a8_forward": 0,
                             "fused_rnn_step": 0,
                             # a whole sequence in one launch of the same
                             # library (fused_rnn_seq)
                             "fused_rnn_step.seq": 0,
                             # the collectives of parallel/: the one-shot
                             # (ranks on one card) under the kernel's name,
                             # the ring protocol (several cards) as .ring
                             "ring_all_reduce": 0, "bidir_ring": 0,
                             "ring_all_reduce.ring": 0, "bidir_ring.ring": 0}


def launch_counts() -> Dict[str, int]:
    """How many times each kernel was launched since the last reset."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0


# a CUDA graph's capture: the thread that captures records its wrapper calls
# here (they only enter the graph) instead of counting them as launches
_held = threading.local()


def _count(name: str) -> None:
    held = getattr(_held, "counts", None)
    if held is not None:
        held[name] = held.get(name, 0) + 1
        return
    with _launch_lock:
        _launches[name] += 1


@contextlib.contextmanager
def held_launches():
    """Inside, this thread's wrapper calls are not counted but recorded in
    the dict it yields: a CUDA graph's capture, whose kernels run (and are
    counted by :func:`count_launches`) each time the graph is replayed."""
    _held.counts = held = {}
    try:
        yield held
    finally:
        _held.counts = None


def count_launches(held: Dict[str, int]) -> None:
    """Count one replay of a captured graph: the launches it holds
    (:func:`held_launches`)."""
    with _launch_lock:
        for name, n in held.items():
            _launches[name] += n


# ---------------------------------------------------------------------------
# The tooling's view of a launch (utils/profiling.py)
# ---------------------------------------------------------------------------

# NaN checks (profiling.enable_nan_checks): each wrapper checks its kernel's
# outputs, since a launch through ctypes is no aten op a dispatch mode sees.
_nan_checks = False
# cost_analysis / memory_analysis: the counting dispatch mode while it runs.
_cost_mode = None


def nan_checks_enabled() -> bool:
    """Whether ``profiling.enable_nan_checks`` is on."""
    return _nan_checks


def _tensors(out) -> List[torch.Tensor]:
    """The tensors of ``out``, a tensor or a nest of tuples, lists, dicts
    and dataclasses, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _check_nan(name: str, out) -> None:
    for t in _tensors(out):
        if (t.is_floating_point() and t.device.type != "meta"
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {name} (a hand-written "
                f"kernel's output, checked under enable_nan_checks)")


def _meta(a):
    """``a`` with every tensor in it replaced by a meta tensor of its
    shape, strides and dtype."""
    if isinstance(a, torch.Tensor):
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                   device="meta")
    if isinstance(a, (tuple, list)):
        return type(a)(_meta(x) for x in a)
    return a


def _watched(name: str, run: Callable, plain: Callable = None,
             args: tuple = (), cost: tuple = None):
    """``run()``, a kernel's launch on the card, under the tooling: the
    dispatch modes (the NaN checks, the counting of ``cost_analysis``) are
    set aside while it runs, so the wrapper's own allocations and copies are
    neither checked nor counted; then the counting mode counts the plain
    version's math, ``plain(*args)`` run on meta tensors of the same shapes
    (or ``cost``, ``(flops, transcendentals, bytes)``), and the NaN checks
    look at the kernel's outputs."""
    from torch.utils._python_dispatch import _disable_current_modes

    mode = _cost_mode
    with _disable_current_modes():
        out = run()
        if _nan_checks:
            _check_nan(name, out)
        if mode is not None and plain is not None:
            margs = _meta(args)
    if mode is not None:
        if plain is not None:
            plain(*margs)
        elif cost is not None:
            mode.add(*cost)
    return out


def _act_fn(name: str) -> Callable:
    if name == "logistic":
        return lambda z: 1.0 / (1.0 + torch.exp(-z))
    if name == "relu":
        return lambda z: torch.clamp_min(z, 0.0)
    if name == "tanh":
        return torch.tanh
    if name == "identity":
        return lambda z: z
    raise ValueError(f"unknown activation {name!r}")


def _act_grad(name: str) -> Callable:
    """d act / d z expressed in terms of z."""
    if name == "logistic":
        def g(z):
            s = 1.0 / (1.0 + torch.exp(-z))
            return s * (1.0 - s)
        return g
    if name == "relu":
        return lambda z: (z > 0).to(z.dtype)
    if name == "tanh":
        return lambda z: 1.0 - torch.tanh(z) ** 2
    if name == "identity":
        return torch.ones_like
    raise ValueError(f"unknown activation {name!r}")


def _check_names(acts: Sequence[str], precision: str) -> None:
    for a in acts:
        if a not in ACT_CODES:
            raise ValueError(f"unknown activation {a!r} "
                             f"(known: {sorted(ACT_CODES)})")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")


_bound: dict = {}


def _kernel(lib_name: str, fn_name: str, argtypes,
            keep_gil: bool = False) -> Callable:
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``, built on
    first use.  ``keep_gil`` binds it through ``ctypes.PyDLL``: the call
    keeps the GIL, which saves its release and re-acquisition around a C
    call that only queues work (the per-call wrappers on the hot path)."""
    key = (fn_name, keep_gil)
    fn = _bound.get(key)
    if fn is None:
        from .cuda_build import build

        built = build(lib_name)
        lib = ctypes.PyDLL(str(built.path)) if keep_gil else built.lib
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_sm_counts: Dict[int, int] = {}


def _sm_count(dev: int) -> int:
    n = _sm_counts.get(dev)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _sm_counts[dev] = n
    return n


def _launch_on(dev: int, fn: Callable, *args) -> int:
    """``fn(*args)`` with card ``dev`` current (a launch goes to the current
    card; a stream of another card would refuse it)."""
    if dev == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


_scratch: Dict[tuple, torch.Tensor] = {}


def _scratch_for(name: str, dev: int, stream: int, numel: int,
                 dtype: torch.dtype, zeroed: bool = False) -> torch.Tensor:
    """A buffer of at least ``numel`` elements kept per (kernel, card,
    stream) and grown as needed, so a launch allocates nothing; the stream
    orders its reuse.  ``zeroed`` buffers start zeroed (the kernels that
    take them leave them so)."""
    key = (name, dev, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        make = torch.zeros if zeroed else torch.empty
        buf = make(max(numel, 1), dtype=dtype, device=torch.device("cuda", dev))
        _scratch[key] = buf
    return buf


def take_scratch(stream: int) -> List[torch.Tensor]:
    """Remove the buffers kept for the raw stream ``stream`` and return
    them.  A CUDA graph captured on that stream keeps them from then on, so
    no later launch on the stream (streams come from a pool and recur) can
    replace a buffer the graph's kernels still write."""
    return [_scratch.pop(k) for k in list(_scratch) if k[2] == stream]


# ---------------------------------------------------------------------------
# Measured plans (ops/autotune.py)
# ---------------------------------------------------------------------------

_device_names: Dict[int, str] = {}


def _device_name(dev: int) -> str:
    """``torch.cuda.get_device_name(dev)``, cached: the card a tuned plan
    was measured on."""
    name = _device_names.get(dev)
    if name is None:
        name = _device_names[dev] = torch.cuda.get_device_name(dev)
    return name


class Tuning(NamedTuple):
    """How ``ops.autotune`` files a kernel's plans: ``key(*shape)`` gives
    the cache key's parameters, ``free(plan)`` the plan's free parameters
    (an entry's ``"plan"``).  Read by the plans' probes (:func:`_tuned`)
    and by the sweeps alike."""
    key: Callable
    free: Callable


def _tuned(kernel: str, device_name, candidates: Callable, *shape):
    """The plan ``ops.autotune`` measured for ``kernel`` at ``shape`` (the
    arguments of its :data:`TUNING` key) on the card named
    ``device_name``, or None (no entry, or no card name).  The entry holds
    the plan's free parameters; it must name one of ``candidates()``, the
    plans that pass the plan's own checks at this shape on this card, or
    ``ValueError`` names the key and the file (a stale or foreign entry is
    never dropped in silence)."""
    if device_name is None:
        return None
    from . import autotune

    tuning = TUNING[kernel]  # defined below, with the plans
    hit = autotune.lookup(kernel, device_name, **tuning.key(*shape))
    if hit is None:
        return None
    key, want, path = hit
    for plan in candidates():
        if list(tuning.free(plan)) == list(want):
            return plan
    raise ValueError(
        f"{kernel}: the tuned plan {want} of {key!r} in {path} does not pass "
        f"the plan's checks at this shape on this card; run the sweep again "
        f"or remove the entry")


def _with_rule(cands: list, rule) -> list:
    """The candidates with the fixed rule's plan among them."""
    return cands if rule in cands else cands + [rule]


def _check_plan(kernel: str, plan, candidates: list):
    """``plan``, an explicit ``plan=``, if it is one of the candidates the
    plan's checks pass at this call's shape; ``ValueError`` otherwise."""
    if plan not in candidates:
        raise ValueError(f"{kernel}: plan {plan} is not one this shape can "
                         f"run on this card (see its candidates)")
    return plan


def _pow2_upto(n: int) -> List[int]:
    out, s = [], 1
    while s <= n:
        out.append(s)
        s *= 2
    return out


_plan_epoch = 0


def plan_epoch() -> int:
    """How many times :func:`clear_plan_caches` has run: part of a compiled
    call's key (``engine.py``), since a CUDA graph keeps the plans it was
    captured with."""
    return _plan_epoch


def clear_plan_caches() -> None:
    """Forget every wrapper's per-shape plans, so that the next call of a
    shape plans again (a new tuned entry takes effect): the counterpart of
    the JAX package's ``jax.clear_caches()`` after a sweep.  The engine's
    graphs of earlier plans are not replayed again."""
    global _plan_epoch
    _plan_epoch += 1
    for cache in (_linear_calls, _mlp_calls, _train_grids, _w8_calls,
                  _w8a8_calls, _mlp8_calls, _seq_routes):
        cache.clear()


# ---------------------------------------------------------------------------
# fused_linear: act(x @ w.T + b)
# ---------------------------------------------------------------------------


def fused_linear_ref(x, w, b, act: str = "identity", save_z: bool = False):
    """Plain PyTorch ``act(x @ w.T + b)``: bf16 operands stay bf16, others
    go through f32, accumulation is f32, and ``y`` has x's dtype.  With
    ``save_z`` it returns ``(y, z)``, z the f32 pre-activation."""
    op = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    z = x.to(op).float() @ w.to(op).float().T + b.float()
    y = _act_fn(act)(z).to(x.dtype)
    return (y, z) if save_z else y


_LINEAR_ENTRIES = {torch.float32: "fused_linear_f32",
                   torch.bfloat16: "fused_linear_bf16"}
# the instances of csrc/fused_linear.cu, by code: (rows, columns, k) of one
# block's output tile and stage, and threads per block.  These and the step
# kernel's TRAIN_* below copy the sources' MidTile, LargeTile, kGemvWarps
# and StepTile; tests/test_torch_kernels.py holds each copy to its source.
LINEAR_INSTANCES = {"gemv": (0, None, 128), "tile": (1, (32, 64, 16), 128),
                    "large": (2, (128, 128, 8), 256)}
GEMV_ROWS = (1, 4, 8, 16)     # the gemv's row bounds; B <= 16 takes it
GEMV_WARPS = 4                # gemv: output columns per block
SPLIT_MIN_K = 64              # tile: the least k a split of K walks
GRID_YZ_MAX = 65535


class LinearPlan(NamedTuple):
    """How ``fused_linear`` runs one shape: the instance, 16-byte loads or
    scalar ones, the gemv's row bound (the tile's rows otherwise), the grid,
    threads per block, the split of K over ``grid[2]`` blocks with
    ``kchunk`` k each, and the f32 scratch the split's partials take."""
    instance: str
    vec: bool
    rows: int
    grid: Tuple[int, int, int]
    block: int
    split: int
    kchunk: int
    scratch_floats: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _linear_make(B: int, K: int, O: int, instance: str, split: int,
                 vec: bool) -> LinearPlan:
    """The plan of ``instance`` with K split over about ``split`` blocks
    (each walking a multiple of the tile's 16 k), or None where the grid is
    more than the card can launch."""
    if instance == "gemv":
        rows = next(r for r in GEMV_ROWS if r >= B)
        return LinearPlan("gemv", vec, rows, (_cdiv(O, GEMV_WARPS), 1, 1),
                          LINEAR_INSTANCES["gemv"][2], 1, max(K, 1), 0)
    bm, bn, bk = LINEAR_INSTANCES[instance][1]
    gx, gy = _cdiv(O, bn), _cdiv(B, bm)
    if gy > GRID_YZ_MAX:
        return None
    kchunk = max(K, 1)
    if split > 1:
        kchunk = _cdiv(_cdiv(K, split), bk) * bk
        split = _cdiv(K, kchunk)
    return LinearPlan(instance, vec, bm, (gx, gy, split),
                      LINEAR_INSTANCES[instance][2], split, kchunk,
                      split * B * O if split > 1 else 0)


def _linear_free(plan: LinearPlan) -> list:
    return [plan.instance, plan.split]


def _linear_rule(B: int, K: int, O: int, vec: bool, sms: int) -> LinearPlan:
    if B <= GEMV_ROWS[-1]:
        return _linear_make(B, K, O, "gemv", 1, vec)
    bm, bn, _ = LINEAR_INSTANCES["large"][1]
    gx, gy = _cdiv(O, bn), _cdiv(B, bm)
    if gx * gy >= sms:
        instance = "large"
    else:
        instance = "tile"
        bm, bn, _ = LINEAR_INSTANCES["tile"][1]
        gx, gy = _cdiv(O, bn), _cdiv(B, bm)
    if gy > GRID_YZ_MAX:
        raise ValueError(f"fused_linear: {B} rows need {gy} row tiles, more "
                         f"than the grid's {GRID_YZ_MAX}")
    split = 1
    if instance == "tile" and gx * gy < sms and K > SPLIT_MIN_K:
        split = min(_cdiv(sms, gx * gy), _cdiv(K, SPLIT_MIN_K))
    return _linear_make(B, K, O, instance, split, vec)


def _linear_check_dtype(dtype) -> None:
    if dtype not in _LINEAR_ENTRIES:
        raise ValueError(f"fused_linear on CUDA takes float32 or bfloat16 "
                         f"x, got {dtype}")


def linear_plan(B: int, K: int, O: int, dtype=torch.float32,
                aligned: bool = True, sms: int = H100_SMS, *,
                device_name: str = None) -> LinearPlan:
    """The instance of ``fused_linear`` for x (B, K), w (O, K), a fixed
    rule:

    * B <= 16: ``gemv``, one warp per output column, 4 columns a block;
    * at least ``sms`` 128 x 128 output tiles: ``large``;
    * otherwise ``tile`` (32 x 64 output tiles); where the tiles are fewer
      than ``sms`` and K > 64, K is split over enough blocks to give every
      SM one (each split walking at least 64 k, a multiple of 16), the
      partials added in split order by the last block of each tile.

    ``vec`` (16-byte loads) needs K % 4 == 0 and ``aligned`` operands (x
    and w 4-element aligned); otherwise the same instance loads scalars.
    f32 and bf16 operands take the same plan.  With ``device_name`` (the
    card's name, as the wrapper passes it) an entry of ``ops.autotune``'s
    cache for this shape and card replaces the rule (it must be one of
    :func:`linear_candidates`).  Raises ``ValueError`` for a dtype the
    kernel does not take, a grid the card cannot launch or a stale tuned
    entry."""
    _linear_check_dtype(dtype)
    vec = K % 4 == 0 and aligned
    tuned = _tuned("linear", device_name,
                   lambda: linear_candidates(B, K, O, dtype, aligned, sms),
                   B, K, O, dtype)
    return tuned if tuned is not None else _linear_rule(B, K, O, vec, sms)


def linear_candidates(B: int, K: int, O: int, dtype=torch.float32,
                      aligned: bool = True,
                      sms: int = H100_SMS) -> List[LinearPlan]:
    """Every plan ``fused_linear`` can run at this shape, for the tuner:
    the gemv (B <= 16), the tile with K split over 1, 2, 4, .. blocks (each
    a multiple of 16 k, at most 64 splits) and the large tile, the fixed
    rule's plan among them."""
    _linear_check_dtype(dtype)
    vec = K % 4 == 0 and aligned
    wanted = [("gemv", 1)] if B <= GEMV_ROWS[-1] else []
    bk = LINEAR_INSTANCES["tile"][1][2]
    wanted += [("tile", s) for s in _pow2_upto(min(64, _cdiv(K, bk)))]
    wanted.append(("large", 1))
    cands, seen = [], set()
    for instance, split in wanted:
        plan = _linear_make(B, K, O, instance, split, vec)
        if plan is not None and tuple(_linear_free(plan)) not in seen:
            seen.add(tuple(_linear_free(plan)))
            cands.append(plan)
    return _with_rule(cands, _linear_rule(B, K, O, vec, sms))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


_linear_calls: dict = {}  # (B, K, O, dtype, aligned, card) -> (plan, entry)
_LINEAR_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                    + [ctypes.c_void_p] * 3)


def _fused_linear_cuda(x, w, b, act: str, save_z: bool, plan=None):
    """The kernel: f32 x with f32 operands, or bf16 x with bf16 operands (w
    rounded to bf16 as the plain version rounds it); f32 accumulation, b
    and z f32, y in x's dtype.  The instance is ``plan`` (one of
    :func:`linear_candidates`) or ``linear_plan``'s, cached per call
    shape."""
    entry = _LINEAR_ENTRIES.get(x.dtype)
    if entry is None:
        raise ValueError(f"fused_linear on CUDA takes float32 or bfloat16 "
                         f"x, got {x.dtype}")
    if (x.ndim != 2 or w.ndim != 2 or b.ndim != 1
            or w.shape[1] != x.shape[1] or b.shape[0] != w.shape[0]):
        raise ValueError(f"fused_linear wants x (B, K), w (O, K), b (O,); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    dev = x.get_device()
    if w.get_device() != dev or b.get_device() != dev:
        raise ValueError("fused_linear: x, w and b must be on one device")
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if b.dtype != torch.float32:
        b = b.float()
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    B, K = x.shape
    O = w.shape[0]
    y = x.new_empty((B, O))
    z = x.new_empty((B, O), dtype=torch.float32) if save_z else None
    if B == 0 or O == 0:
        return y, z
    xp, wp = x.data_ptr(), w.data_ptr()
    aligned = (xp | wp) % (4 * x.element_size()) == 0
    key = (B, K, O, x.dtype, aligned, dev, plan)
    call = _linear_calls.get(key)
    if call is None:
        sms = _sm_count(dev)
        chosen = (linear_plan(B, K, O, x.dtype, aligned, sms,
                              device_name=_device_name(dev))
                  if plan is None else _check_plan(
                      "fused_linear", plan,
                      linear_candidates(B, K, O, x.dtype, aligned, sms)))
        call = (chosen, _kernel("fused_linear", entry, _LINEAR_ARGTYPES,
                                keep_gil=True))
        _linear_calls[key] = call
    plan, fn = call
    stream = torch._C._cuda_getCurrentRawStream(dev)
    part = counters = None
    if plan.split > 1:
        part = _scratch_for("fused_linear.part", dev, stream,
                            plan.scratch_floats, torch.float32).data_ptr()
        counters = _scratch_for("fused_linear.counters", dev, stream,
                                plan.grid[0] * plan.grid[1], torch.int32,
                                zeroed=True).data_ptr()
    err = _launch_on(dev, fn, xp, wp, b.data_ptr(), y.data_ptr(),
                     None if z is None else z.data_ptr(), B, K, O,
                     ACT_CODES[act], LINEAR_INSTANCES[plan.instance][0],
                     int(plan.vec), plan.rows, *plan.grid, plan.kchunk, part,
                     counters, stream)
    if err:
        _check_launch("fused_linear", err)
    _count("fused_linear")
    return y, z


class _FusedLinear(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU).  Backward:
    plain PyTorch, the math of ``_fused_linear_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, act, save_z, plan):
        if x.is_cuda:
            run = lambda: _fused_linear_cuda(x, w, b, act, save_z, plan)  # noqa: E731
            if _nan_checks or _cost_mode is not None:
                y, z = _watched("fused_linear", run, fused_linear_ref,
                                (x, w, b, act, True))
            else:
                y, z = run()
        else:
            y, z = fused_linear_ref(x, w, b, act, save_z=True)
        if save_z:
            ctx.save_for_backward(x, w, b, z)
            ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, z = ctx.saved_tensors
        dz = (dy.float() * _act_grad(ctx.act)(z)).to(x.dtype)
        dx = (dz.float() @ w.float()).to(x.dtype)
        dw = (dz.float().T @ x.float()).to(w.dtype)
        db = dz.sum(dim=0).to(b.dtype)
        return dx, dw, db, None, None, None


def fused_linear(x, w, b, act: str = "identity", precision: str = "default",
                 plan: LinearPlan = None):
    """``act(x @ w.T + b)``: x (B, i), w (o, i) in the ffLayer layout
    (``FeedForward.hs:209-213``), b (o,).  Differentiable; the forward
    keeps the f32 pre-activation only when a gradient will be taken.  On
    the card ``plan`` (one of :func:`linear_candidates`) replaces
    :func:`linear_plan`'s; the plain version ignores it."""
    _check_names([act], precision)
    save_z = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, b))
    return _FusedLinear.apply(x, w, b, act, save_z, plan)


# ---------------------------------------------------------------------------
# fused_mlp_forward: the whole chain in one launch
# ---------------------------------------------------------------------------


def fused_mlp_forward_ref(x, weights, biases, acts: Sequence[str],
                          softmax_out: bool = True):
    """Plain PyTorch whole-chain forward: f32 throughout, ``acts[k]``
    after layer k, and a softmax instead of the last activation when
    ``softmax_out``.  The result has x's dtype."""
    h = x.float()
    n = len(weights)
    for k in range(n):
        z = h @ weights[k].float().T + biases[k].float()
        if k == n - 1 and softmax_out:
            h = torch.softmax(z, dim=-1)
        else:
            h = _act_fn(acts[k])(z)
    return h.to(x.dtype)


MLP_CLUSTER = 16          # fused_mlp_forward: blocks per row tile (a cluster)
MLP_THREADS = 512         # fused_mlp_forward: threads per block
MLP_ROWS = (1, 2, 4, 8)   # fused_mlp_forward: its row-tile instances


class MlpPlan(NamedTuple):
    """How ``fused_mlp_forward`` runs a batch: tiles of ``rows`` rows, each
    one cluster of :data:`MLP_CLUSTER` blocks (``tiles`` clusters, ``blocks``
    blocks in all), activation rows of ``stride`` floats in two buffers,
    ``smem_bytes`` per block with the layers' mbarriers."""
    rows: int
    stride: int
    tiles: int
    blocks: int
    smem_bytes: int


def _mlp_stride(widths: Sequence[int]) -> int:
    stride = _cdiv(max(widths), 4) * 4
    return stride + 4 if stride % 32 == 0 else stride


def _mlp_smem(rows: int, stride: int) -> int:
    return 2 * rows * stride * 4 + 8 * MAX_LAYERS


def _mlp_make(batch: int, stride: int, rows: int) -> MlpPlan:
    tiles = _cdiv(batch, rows)
    return MlpPlan(rows, stride, tiles, tiles * MLP_CLUSTER,
                   _mlp_smem(rows, stride))


def _mlp_rows_cover(batch: int) -> int:
    return next(r for r in MLP_ROWS if r >= min(batch, MLP_ROWS[-1]))


def _mlp_rule(batch: int, widths: Sequence[int]) -> MlpPlan:
    stride = _mlp_stride(widths)
    rows = _mlp_rows_cover(batch)
    while rows > 1 and _mlp_smem(rows, stride) > MAX_SMEM_BYTES:
        rows //= 2
    if _mlp_smem(1, stride) > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_mlp_forward: a layer width of {max(widths)} needs "
            f"{2 * stride * 4} bytes of shared memory per batch row, more "
            f"than the {MAX_SMEM_BYTES} one block has")
    return _mlp_make(batch, stride, rows)


def mlp_forward_plan(batch: int, widths: Sequence[int], *,
                     device_name: str = None) -> MlpPlan:
    """The whole-chain kernel's plan for ``batch`` rows through layers of
    ``widths`` (``[i, o_0, .., o_{L-1}]``), a fixed rule: the row tile is
    the least of :data:`MLP_ROWS` that covers ``min(batch, 8)``, halved
    while its two ``rows x stride`` f32 buffers and the 16 layers' 8-byte
    mbarriers overflow one block's shared memory; ``stride`` is the widest
    width rounded up to 4 floats (16-byte rows), plus 4 where that is a
    multiple of 32 (rows on distinct banks).  With ``device_name`` a tuned
    entry (one of :func:`mlp_forward_candidates`) replaces the rule.
    Raises ``ValueError`` naming the width when not even one row fits, and
    for a stale tuned entry."""
    tuned = _tuned("mlp_fwd", device_name,
                   lambda: mlp_forward_candidates(batch, widths), batch,
                   widths)
    return tuned if tuned is not None else _mlp_rule(batch, widths)


def mlp_forward_candidates(batch: int,
                           widths: Sequence[int]) -> List[MlpPlan]:
    """Every row tile of :data:`MLP_ROWS` up to the one that covers the
    batch whose buffers fit one block's shared memory, for the tuner."""
    rule = _mlp_rule(batch, widths)
    cands = [_mlp_make(batch, rule.stride, r) for r in MLP_ROWS
             if r <= _mlp_rows_cover(batch)
             and _mlp_smem(r, rule.stride) <= MAX_SMEM_BYTES]
    return _with_rule(cands, rule)


_mlp_calls: dict = {}  # (B, dims, acts, softmax_out, card) -> call
_MLP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _mlp_widths(x, weights, biases) -> List[int]:
    """``[i, o_0, .., o_{L-1}]`` after checking the layer count, the shapes
    and that every tensor is on x's device."""
    n = len(weights)
    if n > MAX_LAYERS:
        raise ValueError(f"fused_mlp_forward: {n} layers exceed the "
                         f"kernel's {MAX_LAYERS}")
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_forward wants x (B, i), got "
                         f"{tuple(x.shape)}")
    dims = [x.shape[1]]
    for w, b in zip(weights, biases):
        if (w.ndim != 2 or w.shape[1] != dims[-1]
                or tuple(b.shape) != (w.shape[0],)):
            raise ValueError(
                f"fused_mlp_forward: layer {len(dims) - 1} has w "
                f"{tuple(w.shape)}, b {tuple(b.shape)} after width "
                f"{dims[-1]}")
        if w.device != x.device or b.device != x.device:
            raise ValueError("fused_mlp_forward: x and every weight and "
                             "bias must be on one device")
        dims.append(w.shape[0])
    return dims


def _fused_mlp_forward_cuda(x, weights, biases, acts, softmax_out,
                            plan=None):
    """The kernel: ``plan``'s or ``mlp_forward_plan``'s row tiles, one
    cluster each; the plan, the C entry and the ctypes widths and
    activations cached per call shape."""
    n, B, dev = len(weights), x.shape[0], x.get_device()
    key = (tuple(x.shape), tuple(tuple(w.shape) for w in weights),
           tuple(tuple(b.shape) for b in biases), tuple(acts),
           bool(softmax_out), dev, plan)
    call = _mlp_calls.get(key)
    if call is None:
        dims = _mlp_widths(x, weights, biases)
        chosen = (mlp_forward_plan(B, dims, device_name=_device_name(dev))
                  if plan is None else _check_plan(
                      "fused_mlp_forward", plan,
                      mlp_forward_candidates(B, dims)))
        call = (chosen,
                _kernel("fused_mlp_forward", "fused_mlp_forward_f32",
                        _MLP_ARGTYPES, keep_gil=True),
                (ctypes.c_int * (n + 1))(*dims),
                (ctypes.c_int * n)(*(ACT_CODES[a] for a in acts)), dims[-1])
        _mlp_calls[key] = call
    elif any(t.device != x.device for t in (*weights, *biases)):
        raise ValueError("fused_mlp_forward: x and every weight and bias "
                         "must be on one device")
    plan, fn, c_dims, c_acts, n_out = call
    xf = _f32(x)
    ws = [_f32(w) for w in weights]
    bs = [_f32(b) for b in biases]
    y = xf.new_empty((B, n_out))
    if B == 0:
        return y.to(x.dtype)
    w_ptrs = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
    b_ptrs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
    err = _launch_on(dev, fn, xf.data_ptr(), y.data_ptr(), B, plan.rows, n,
                     w_ptrs, b_ptrs, c_dims, c_acts, int(bool(softmax_out)),
                     plan.stride, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _check_launch("fused_mlp_forward", err)
    _count("fused_mlp_forward")
    return y.to(x.dtype)


def fused_mlp_forward(x, weights, biases, acts: Sequence[str],
                      softmax_out: bool = True, precision: str = "default",
                      plan: MlpPlan = None):
    """Whole ffLayer-chain forward in ONE kernel launch: one cluster of 16
    blocks per batch tile, the tile's activations in every block's shared
    memory across layers, each layer's columns spread over the cluster's
    warps, the weights streamed from L2.

    weights[k]: (o_k, i_k) with i_{k+1} == o_k; acts[k] applied after
    layer k (the last layer uses a softmax over its real width when
    ``softmax_out``).  Weights of any float dtype are read as f32.  The
    batch tile is ``plan``'s (one of :func:`mlp_forward_candidates`) or
    :func:`mlp_forward_plan`'s; the plain version ignores ``plan``."""
    if not (len(weights) == len(biases) == len(acts)) or not weights:
        raise ValueError("fused_mlp_forward: need one weight, bias and "
                         "activation per layer")
    _check_names(acts, precision)
    if x.is_cuda:
        run = lambda: _fused_mlp_forward_cuda(  # noqa: E731
            x, weights, biases, acts, softmax_out, plan)
        if _nan_checks or _cost_mode is not None:
            return _watched("fused_mlp_forward", run, fused_mlp_forward_ref,
                            (x, weights, biases, acts, softmax_out))
        return run()
    return fused_mlp_forward_ref(x, weights, biases, acts, softmax_out)


# ---------------------------------------------------------------------------
# fused_mlp_train_step: one whole SGD step
# ---------------------------------------------------------------------------


def fused_mlp_train_step_ref(x, y, weights, biases, lr, acts: Sequence[str],
                             precision: str = "default",
                             loss_kind: str = "softmax_xent"):
    """Plain PyTorch whole SGD step, the math of the TPU kernel
    ``_mlp_train_kernel``: forward in f32 (in f64 when x is f64, for an
    exact reference); softmax + cross-entropy
    ``-sum y log(where(p > 0, p, 1))`` or ``acts[-1]`` + squared error
    summed over the outputs; both meaned over the batch; the explicit
    backward of the mean; ``w - lr * g``.  Returns ``(loss, new_weights,
    new_biases)``, each new parameter in its old dtype."""
    n = len(weights)
    batch = x.shape[0]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = x.to(ft)
    hs, zs = [h], []
    for k in range(n):
        z = h @ weights[k].to(ft).T + biases[k].to(ft)
        zs.append(z)
        if k < n - 1:
            h = _act_fn(acts[k])(z)
            hs.append(h)
    y = y.to(ft)
    if loss_kind == "softmax_xent":
        p = torch.softmax(zs[-1], dim=-1)
        logp = torch.log(torch.where(p > 0, p, torch.ones_like(p)))
        loss = -(y * logp).sum() / batch
        dz = (p - y) / batch
    else:
        d = _act_fn(acts[-1])(zs[-1]) - y
        loss = (d * d).sum() / batch
        dz = (2.0 * d) * _act_grad(acts[-1])(zs[-1]) / batch
    new_ws, new_bs = [None] * n, [None] * n
    for k in range(n - 1, -1, -1):
        w = weights[k].to(ft)
        new_ws[k] = (w - lr * (dz.T @ hs[k])).to(weights[k].dtype)
        new_bs[k] = (biases[k].to(ft) - lr * dz.sum(dim=0)).to(
            biases[k].dtype)
        if k > 0:
            dz = (dz @ w) * _act_grad(acts[k - 1])(zs[k - 1])
    return loss, new_ws, new_bs


TRAIN_THREADS = 256   # threads per block of the step kernel
TRAIN_TILE = 32       # rows and columns of its output tiles


def train_stages(n_layers: int) -> List[str]:
    """The step kernel's stages in order, a grid barrier between each two:
    ``F0 .. F{L-1}`` (forward), ``loss`` (softmax or squared error, the
    last layer's dz), ``G{L-1} .. G0`` (each layer's update and the dz of
    the layer below)."""
    return ([f"F{l}" for l in range(n_layers)] + ["loss"]
            + [f"G{l}" for l in reversed(range(n_layers))])


def train_step_scratch_floats(batch: int, widths: Sequence[int]) -> int:
    """f32 scratch of one step (``csrc/fused_mlp_train_step.cu``'s layout):
    each layer's output h_1 .. h_L and two dz buffers of the widest, ``batch
    x width`` each with rows padded to 4 floats, and a loss per row.  x is
    read in place."""
    outs = [-(-d // 4) * 4 for d in widths[1:]]
    return batch * sum(outs) + 2 * batch * max(outs) + batch


def train_grid(capacity: int, sms: int, batch: int,
               widths: Sequence[int], *, device_name: str = None) -> int:
    """The step kernel's grid: one block per SM (``sms``), at most the
    blocks the card holds at once (``capacity``), since the stages meet at
    grid barriers, whose cost grows with the blocks that meet (a second
    block per SM made the step slower on the H100).  With ``device_name`` a
    tuned grid (one of :func:`train_grid_candidates`) replaces the rule.
    Raises ``ValueError`` naming the shapes when the card holds none, and
    for a stale tuned entry."""
    if capacity < 1:
        raise ValueError(
            f"fused_mlp_train_step: the card cannot hold a cooperative grid "
            f"of the step kernel ({capacity} co-resident blocks of "
            f"{TRAIN_THREADS} threads) for widths "
            f"{'-'.join(map(str, widths))} at batch {batch}")
    tuned = _tuned("mlp_train", device_name,
                   lambda: train_grid_candidates(capacity, sms, batch,
                                                 widths), batch, widths)
    return tuned if tuned is not None else min(capacity, sms)


def train_grid_candidates(capacity: int, sms: int, batch: int,
                          widths: Sequence[int]) -> List[int]:
    """Grids of the step kernel for the tuner: a quarter, a half, three
    quarters and all of the SMs, and every block the card holds at once
    (at most ``capacity``), the rule's grid among them."""
    rule = train_grid(capacity, sms, batch, widths)
    cands = sorted({g for g in (sms // 4, sms // 2, 3 * sms // 4, sms,
                                capacity) if 1 <= g <= capacity})
    return _with_rule(cands, rule)


def _train_step_widths(x, y, weights, biases) -> List[int]:
    """The chain's widths ``[i, o_0, .., o_{L-1}]`` after checking the
    shapes, the layer count and that every tensor is on x's device."""
    n = len(weights)
    if n > MAX_LAYERS:
        raise ValueError(f"fused_mlp_train_step: {n} layers exceed the "
                         f"kernel's {MAX_LAYERS}")
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"fused_mlp_train_step wants x (B, i) and y (B, o); "
                         f"got {tuple(x.shape)}, {tuple(y.shape)}")
    dims = [x.shape[1]]
    for w, b in zip(weights, biases):
        if (w.ndim != 2 or w.shape[1] != dims[-1]
                or tuple(b.shape) != (w.shape[0],)):
            raise ValueError(
                f"fused_mlp_train_step: layer {len(dims) - 1} has w "
                f"{tuple(w.shape)}, b {tuple(b.shape)} after width "
                f"{dims[-1]}")
        dims.append(w.shape[0])
    batch = x.shape[0]
    if tuple(y.shape) != (batch, dims[-1]):
        raise ValueError(f"fused_mlp_train_step: y is {tuple(y.shape)}, "
                         f"want ({batch}, {dims[-1]})")
    if batch < 1:
        raise ValueError("fused_mlp_train_step: empty batch")
    if any(t.device != x.device for t in (y, *weights, *biases)):
        raise ValueError("fused_mlp_train_step: x, y and every weight and "
                         "bias must be on one device")
    return dims


_train_capacity: Dict[int, int] = {}


def _train_step_capacity(dev: int) -> int:
    """Blocks of the step kernel card ``dev`` holds at once (cached)."""
    cap = _train_capacity.get(dev)
    if cap is None:
        fn = _kernel("fused_mlp_train_step", "fused_mlp_train_step_capacity",
                     [ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        err = _launch_on(dev, fn, ctypes.byref(out))
        _check_launch("fused_mlp_train_step capacity", err)
        cap = _train_capacity[dev] = out.value
    return cap


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32:
        t = t.float()
    return t.contiguous()


_train_grids: dict = {}  # (batch, dims, card, plan) -> grid


def _fused_mlp_train_step_cuda(x, y, weights, biases, lr, acts, loss_kind,
                               plan=None):
    """The kernel: one cooperative launch with a grid barrier between each
    two of :func:`train_stages`, on ``plan`` blocks (one of
    :func:`train_grid_candidates`) or ``train_grid``'s, cached per call
    shape.  A tensor ``lr`` (0-d, on the card) is read by the kernel from
    its memory, a number is passed by value."""
    dims = _train_step_widths(x, y, weights, biases)
    n, batch, dev = len(weights), x.shape[0], x.get_device()
    key = (batch, tuple(dims), dev, plan)
    grid = _train_grids.get(key)
    if grid is None:
        cap, sms = _train_step_capacity(dev), _sm_count(dev)
        grid = (train_grid(cap, sms, batch, dims,
                           device_name=_device_name(dev))
                if plan is None else _check_plan(
                    "fused_mlp_train_step", plan,
                    train_grid_candidates(cap, sms, batch, dims)))
        _train_grids[key] = grid
    xf, yf = _f32(x), _f32(y)
    ws = [_f32(w) for w in weights]
    bs = [_f32(b) for b in biases]
    new_ws = [torch.empty_like(w) for w in ws]
    new_bs = [torch.empty_like(b) for b in bs]
    loss = xf.new_empty(())
    vec = (all(d % 4 == 0 for d in dims[:-1])
           and all(t.data_ptr() % 16 == 0 for t in (xf, *ws)))
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch = _scratch_for("fused_mlp_train_step", dev, stream,
                           train_step_scratch_floats(batch, dims),
                           torch.float32)
    # the forward stages' split-K partials: one 32 x 32 tile per block
    part_cap = grid * TRAIN_TILE * TRAIN_TILE
    part = _scratch_for("fused_mlp_train_step.part", dev, stream, part_cap,
                        torch.float32)
    counters = _scratch_for("fused_mlp_train_step.counters", dev, stream,
                            grid, torch.int32, zeroed=True)
    fn = _kernel("fused_mlp_train_step", "fused_mlp_train_step_f32",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int] + [ctypes.c_void_p] * 6
                 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_acts = (ctypes.c_int * n)(*(ACT_CODES[a] for a in acts))
    if isinstance(lr, torch.Tensor):
        lr_t = _f32(lr.to(x.device).reshape(()))
        lr_val, lr_dev = 0.0, lr_t.data_ptr()
    else:
        lr_val, lr_dev = float(lr), None
    err = _launch_on(dev, fn, xf.data_ptr(), yf.data_ptr(), batch, n,
                     ptrs(ws), ptrs(bs), ptrs(new_ws), ptrs(new_bs), c_dims,
                     c_acts, LOSS_KINDS[loss_kind], lr_val, lr_dev,
                     scratch.data_ptr(), part.data_ptr(), counters.data_ptr(),
                     part_cap, loss.data_ptr(), int(vec), grid, stream)
    _check_launch("fused_mlp_train_step", err)
    _count("fused_mlp_train_step")
    return (loss,
            [nw.to(w.dtype) for nw, w in zip(new_ws, weights)],
            [nb.to(b.dtype) for nb, b in zip(new_bs, biases)])


def fused_mlp_train_step(x, y, weights, biases, lr, acts: Sequence[str],
                         precision: str = "default",
                         loss_kind: str = "softmax_xent", plan: int = None):
    """One whole SGD step of an ffLayer chain: forward, loss, backward and
    ``w -= lr * g``, in one cooperative launch over the whole card.

    x (B, i), y (B, o) targets, weights[k] (o_k, i_k), biases[k] (o_k,).
    ``loss_kind="softmax_xent"`` (the flagship): softmax output and
    cross-entropy, ``acts[-1]`` ignored; ``"squared_error"``: ``acts[-1]``
    output and squared error summed over the outputs (pass ``y = x`` for an
    autoencoder).  Both are meaned over the batch.  ``lr`` is a number or
    a 0-d tensor (on the card the kernel reads it from the card's memory,
    so a CUDA graph of the step takes a new rate at each replay).  Returns
    ``(loss, new_weights, new_biases)``; the loss is a 0-d f32 tensor on
    x's device.  On the card the stages are :func:`train_stages`, over ``plan``
    blocks (one of :func:`train_grid_candidates`) or :func:`train_grid`'s;
    the plain version ignores ``plan``."""
    if not (len(weights) == len(biases) == len(acts)) or not weights:
        raise ValueError("fused_mlp_train_step: need one weight, bias and "
                         "activation per layer")
    _check_names(acts, precision)
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss_kind {loss_kind!r} "
                         f"(known: {sorted(LOSS_KINDS)})")
    if x.is_cuda:
        run = lambda: _fused_mlp_train_step_cuda(  # noqa: E731
            x, y, weights, biases, lr, acts, loss_kind, plan)
        if _nan_checks or _cost_mode is not None:
            return _watched("fused_mlp_train_step", run,
                            fused_mlp_train_step_ref,
                            (x, y, weights, biases, lr, acts, precision,
                             loss_kind))
        return run()
    return fused_mlp_train_step_ref(x, y, weights, biases, lr, acts,
                                    precision, loss_kind)


# ---------------------------------------------------------------------------
# int8 serving: the quantizers and the three int8 kernels
# ---------------------------------------------------------------------------

K_ALIGN = 16             # int8 kernels: codes per 16-byte load along K
INT8_MAX_TILE_ROWS = 16  # int8 kernels: batch rows per block


def _quantize_rows_int8(a: torch.Tensor):
    """Symmetric int8 quantization of each row of ``a`` (2-D): codes
    ``clip(round(a / s), -127, 127)`` and f32 scales ``s = amax / 127``
    (``(rows, 1)``), ``s = 1`` for an all-zero row.  Both divisions are IEEE
    divisions by a tensor: PyTorch on CUDA turns a division by a Python
    scalar into a multiplication by its reciprocal, which rounds otherwise.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    a = a.to(torch.float32)
    amax = a.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weights_int8(w):
    """Per-output-channel symmetric int8 quantization of an ffLayer weight
    ``w: (o, i)``: (int8 codes (o, i), f32 scales (o, 1)) with
    ``w ~= codes * scales`` (``pallas_kernels.quantize_weights_int8``)."""
    return _quantize_rows_int8(w)


def quantize_acts_int8(x):
    """Per-row dynamic symmetric int8 quantization of an activation batch
    ``x: (B, i)``: (int8 codes, f32 scales (B, 1))
    (``pallas_kernels.quantize_acts_int8``)."""
    return _quantize_rows_int8(x)


def padded_width(k: int) -> int:
    """``k`` rounded up to :data:`K_ALIGN`: the row width of int8 codes as
    the int8 kernels read them (16-byte aligned rows)."""
    return -(-k // K_ALIGN) * K_ALIGN


def pad_codes(wq: torch.Tensor) -> torch.Tensor:
    """int8 codes ``(o, i)`` with zero codes appended up to
    :func:`padded_width` ``(i)`` (zeros add nothing to a sum), or ``wq``
    itself when its rows are already aligned.  Models pad once and keep the
    result; an int8 wrapper given unpadded codes pads them per call."""
    k = wq.shape[1]
    if k == padded_width(k):
        return wq
    return torch.nn.functional.pad(wq, (0, padded_width(k) - k))


def int8_tile_rows(batch: int, k_padded: int, bytes_per_value: int) -> int:
    """Batch rows per block of the int8 kernels' first design: the power of
    two that covers the batch, at most :data:`INT8_MAX_TILE_ROWS`, halved
    until the rows' ``k_padded`` values of ``bytes_per_value`` bytes fit one
    block's shared memory.  Raises ``ValueError`` when not even one row
    fits.  Its callers now: the width refusals of :func:`w8_plan` (f32 rows)
    and :func:`mlp_w8a8_plan` (rows of codes), and the tools that time an
    older checkout's kernels 4 and 5, whose C entries took these rows."""
    rows = 1
    while rows < min(batch, INT8_MAX_TILE_ROWS):
        rows *= 2
    while rows > 1 and rows * k_padded * bytes_per_value > MAX_SMEM_BYTES:
        rows //= 2
    if k_padded * bytes_per_value > MAX_SMEM_BYTES:
        raise ValueError(
            f"int8 kernels: an input width of {k_padded} needs "
            f"{k_padded * bytes_per_value} bytes of shared memory per batch "
            f"row, more than the {MAX_SMEM_BYTES} one block has")
    return rows


def _int8_shapes(name: str, x, wq, scale, b):
    """(B, K, O) of an int8 layer, after checking x (B, K), wq (O, K) or
    (O, padded_width(K)) int8, scale of O values and b (O,)."""
    if x.ndim != 2 or wq.ndim != 2 or b.ndim != 1:
        raise ValueError(f"{name} wants x (B, i), wq (o, i), b (o,); got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(b.shape)}")
    if wq.dtype != torch.int8:
        raise ValueError(f"{name}: wq must be int8 codes, got {wq.dtype}")
    B, K = x.shape
    O = wq.shape[0]
    if (wq.shape[1] not in (K, padded_width(K)) or b.shape[0] != O
            or scale.numel() != O):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, scale {tuple(scale.shape)}, b "
                         f"{tuple(b.shape)} disagree")
    if any(t.device != x.device for t in (wq, scale, b)):
        raise ValueError(f"{name}: x, wq, scale and b must be on one device")
    return B, K, O


def _aligned_f32(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous f32 tensor whose data starts on a 16-byte boundary
    (the int8 kernels read its rows with 16-byte loads)."""
    x = x.to(torch.float32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _int8_operands(x, wq, scale, b):
    """The kernels' operands: x f32 and 16-byte aligned, codes padded to
    16-byte rows, scale and bias as f32 vectors, all contiguous."""
    q = pad_codes(wq).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    return (_aligned_f32(x), q,
            scale.to(torch.float32).reshape(-1).contiguous(),
            b.to(torch.float32).contiguous())


def fused_linear_w8_ref(x, wq, scale, b, act: str = "identity",
                        precision: str = "default"):
    """Plain PyTorch ``act(x @ (wq * scale).T + b)``: the codes are
    dequantized in f32; at ``"default"`` x and the dequantized weight are
    rounded to bf16 (their products are exact in f32), at ``"highest"``
    everything stays f32.  Codes past column i (padding) are ignored.  The
    result has x's dtype."""
    K = x.shape[1]
    w = wq[:, :K].to(torch.float32) * scale.to(torch.float32).reshape(-1, 1)
    xf = x.to(torch.float32)
    if precision != "highest":
        xf = xf.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    z = xf @ w.T + b.to(torch.float32)
    return _act_fn(act)(z).to(x.dtype)


# the instances of csrc/fused_linear_w8.cu, by code: (rows, columns, k) of
# one block's output tile and stage, and threads per block; the gemv's
# columns per block and row bounds.  tests/test_torch_kernels.py holds each
# copy to its source.
W8_INSTANCES = {"gemv": (0, None, 256), "mma": (1, (32, 32, 32), 128),
                "simt": (2, (32, 64, 16), 128)}
W8_GEMV_WARPS = 4        # gemv: output columns per block (two warps each)
W8_GEMV_ROWS = (1, 4, 8, 16)
W8_GEMV_K = 16           # gemv: codes per 16-byte load, the step of a split
# The least k a split of K walks.  A split costs one more round trip through
# L2 (each split's partial written, the last block adding them): about
# 1.2-1.5 us on the H100, which the gemv's flagship layers (K <= 784) never
# won back, while the tiles' 784-deep layers at B = 64 ran in 0.6x the time
# split five ways (chip_smoke.py's phase 6 shapes, timed by a probe).
W8_SPLIT_MIN_K = 128
W8_GEMV_SPLIT_MIN_K = 1024


class W8Plan(NamedTuple):
    """How ``fused_linear_w8`` runs one shape: the instance, 16-byte loads
    of x or scalar ones, the gemv's row bound (the tile's rows otherwise),
    the grid (columns, rows, splits of K), threads per block, the split of K
    over ``grid[2]`` blocks with ``kchunk`` k each, and the f32 scratch the
    split's partials take."""
    instance: str
    vec: bool
    rows: int
    grid: Tuple[int, int, int]
    block: int
    split: int
    kchunk: int
    scratch_floats: int


def _w8_make(B: int, K: int, O: int, instance: str, split: int) -> W8Plan:
    """The plan of ``instance`` with K split over about ``split`` blocks
    (each a multiple of the instance's k step), or None where the grid is
    more than the card can launch."""
    if instance == "gemv":
        bk = W8_GEMV_K
        rows = next(r for r in W8_GEMV_ROWS if r >= B)
        gx, gy = _cdiv(O, W8_GEMV_WARPS), 1
    else:
        rows, bn, bk = W8_INSTANCES[instance][1]
        gx, gy = _cdiv(O, bn), _cdiv(B, rows)
    if gy > GRID_YZ_MAX:
        return None
    kchunk = max(K, 1)
    if split > 1:
        kchunk = _cdiv(_cdiv(K, split), bk) * bk
        split = _cdiv(K, kchunk)
    return W8Plan(instance, K % 4 == 0, rows, (gx, gy, split),
                  W8_INSTANCES[instance][2], split, kchunk,
                  split * B * O if split > 1 else 0)


def _w8_rule(B: int, K: int, O: int, precision: str, sms: int) -> W8Plan:
    if B <= W8_GEMV_ROWS[-1]:
        instance, min_k = "gemv", W8_GEMV_SPLIT_MIN_K
        gx, gy = _cdiv(O, W8_GEMV_WARPS), 1
    else:
        instance = "mma" if precision == "default" else "simt"
        rows, bn, _ = W8_INSTANCES[instance][1]
        gx, gy, min_k = _cdiv(O, bn), _cdiv(B, rows), W8_SPLIT_MIN_K
    if gy > GRID_YZ_MAX:
        raise ValueError(f"fused_linear_w8: {B} rows need {gy} row tiles, "
                         f"more than the grid's {GRID_YZ_MAX}")
    split = 1
    if gx * gy < sms and K >= 2 * min_k:
        split = min(_cdiv(sms, gx * gy), K // min_k)
    return _w8_make(B, K, O, instance, split)


def _w8_checks(B: int, K: int, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    int8_tile_rows(B, padded_width(K), 4)


def w8_plan(B: int, K: int, O: int, precision: str = "default",
            sms: int = H100_SMS, *, device_name: str = None) -> W8Plan:
    """The instance of ``fused_linear_w8`` for x (B, K) and codes (O,
    padded_width(K)), a fixed rule:

    * B <= 16: ``gemv``, a warp per output column, 4 columns a block;
    * B > 16 at ``"default"``: ``mma``, 32 x 32 tiles on the bf16 tensor
      cores; at ``"highest"``: ``simt``, the fp32 SIMT tile (32 x 64);

    and where the blocks are fewer than ``sms``, K is split over enough
    blocks to give every SM one, as long as each split walks at least
    :data:`W8_SPLIT_MIN_K` k (:data:`W8_GEMV_SPLIT_MIN_K` for the gemv), a
    multiple of the instance's k step; the partials are added in split
    order by the last block of each tile.  ``vec`` (16-byte loads of x) needs
    K % 4 == 0.  With ``device_name`` a tuned entry (one of
    :func:`w8_candidates`) replaces the rule.  Raises ``ValueError`` for a K
    whose padded rows do not fit one block's shared memory as f32 (the
    refusal of :func:`int8_tile_rows`), for a grid the card cannot launch
    and for a stale tuned entry."""
    _w8_checks(B, K, precision)
    tuned = _tuned("linear_w8", device_name,
                   lambda: w8_candidates(B, K, O, precision, sms),
                   B, K, O, precision)
    return tuned if tuned is not None else _w8_rule(B, K, O, precision, sms)


def w8_candidates(B: int, K: int, O: int, precision: str = "default",
                  sms: int = H100_SMS) -> List[W8Plan]:
    """Every plan ``fused_linear_w8`` can run at this shape and precision,
    for the tuner: the gemv (B <= 16) and the precision's tile (``mma`` at
    ``"default"``, ``simt`` at ``"highest"``), each with K split over 1, 2,
    4, .. blocks (a multiple of the instance's k step, at most 64 splits),
    the fixed rule's plan among them."""
    _w8_checks(B, K, precision)
    tile = "mma" if precision == "default" else "simt"
    instances = (["gemv"] if B <= W8_GEMV_ROWS[-1] else []) + [tile]
    cands, seen = [], set()
    for instance in instances:
        bk = W8_GEMV_K if instance == "gemv" else W8_INSTANCES[instance][1][2]
        for split in _pow2_upto(min(64, _cdiv(K, bk))):
            plan = _w8_make(B, K, O, instance, split)
            if plan is not None and (instance, plan.split) not in seen:
                seen.add((instance, plan.split))
                cands.append(plan)
    return _with_rule(cands, _w8_rule(B, K, O, precision, sms))


_w8_calls: dict = {}  # (B, K, Kp, O, precision, card) -> (plan, entry)
_W8_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _fused_linear_w8_cuda(x, wq, scale, b, act, precision, plan=None):
    """The kernel: ``plan``'s or ``w8_plan``'s instance, the plan and the C
    entry cached per call shape, the split's scratch kept per card and
    stream."""
    B, K, O = _int8_shapes("fused_linear_w8", x, wq, scale, b)
    xf, q, s, bf = _int8_operands(x, wq, scale, b)
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0:
        return y.to(x.dtype)
    dev, Kp = x.get_device(), q.shape[1]
    key = (B, K, Kp, O, precision, dev, plan)
    call = _w8_calls.get(key)
    if call is None:
        sms = _sm_count(dev)
        chosen = (w8_plan(B, K, O, precision, sms,
                          device_name=_device_name(dev))
                  if plan is None else _check_plan(
                      "fused_linear_w8", plan,
                      w8_candidates(B, K, O, precision, sms)))
        call = (chosen,
                _kernel("fused_linear_w8", "fused_linear_w8_f32",
                        _W8_ARGTYPES, keep_gil=True))
        _w8_calls[key] = call
    plan, fn = call
    stream = torch._C._cuda_getCurrentRawStream(dev)
    part = counters = None
    if plan.split > 1:
        part = _scratch_for("fused_linear_w8.part", dev, stream,
                            plan.scratch_floats, torch.float32).data_ptr()
        counters = _scratch_for("fused_linear_w8.counters", dev, stream,
                                plan.grid[0] * plan.grid[1], torch.int32,
                                zeroed=True).data_ptr()
    err = _launch_on(dev, fn, xf.data_ptr(), q.data_ptr(), s.data_ptr(),
                     bf.data_ptr(), y.data_ptr(), B, K, Kp, O,
                     ACT_CODES[act], W8_INSTANCES[plan.instance][0],
                     int(plan.vec), plan.rows, *plan.grid, plan.kchunk, part,
                     counters, int(precision == "highest"), stream)
    if err:
        _check_launch("fused_linear_w8", err)
    _count("fused_linear_w8")
    return y.to(x.dtype)


def fused_linear_w8(x, wq, scale, b, act: str = "identity",
                    precision: str = "default", plan: W8Plan = None):
    """``act(x @ (wq * scale).T + b)`` with int8 weights dequantized in the
    kernel.  x (B, i); wq (o, i) int8 codes, or (o, padded_width(i)) with
    zero codes past i (:func:`pad_codes`); scale (o, 1) or (o,) f32; b
    (o,).  Not differentiable (a serving kernel).  On the card the instance
    is ``plan``'s (one of :func:`w8_candidates`) or :func:`w8_plan`'s; the
    plain version ignores ``plan``."""
    _check_names([act], precision)
    if x.is_cuda:
        run = lambda: _fused_linear_w8_cuda(  # noqa: E731
            x, wq, scale, b, act, precision, plan)
        if _nan_checks or _cost_mode is not None:
            return _watched("fused_linear_w8", run, fused_linear_w8_ref,
                            (x, wq, scale, b, act, precision))
        return run()
    return fused_linear_w8_ref(x, wq, scale, b, act, precision)


def fused_linear_w8a8_ref(x, wq, scale, b, act: str = "identity"):
    """Plain PyTorch ``act((xq @ wq.T) * sx * sw.T + b)``: x quantized per
    row (:func:`quantize_acts_int8`), the int8 products summed exactly (in
    f64, exact below 2**53, since PyTorch has no int32 matmul on CUDA), the
    sum rounded once to f32, then ``((acc * sx) * sw) + b`` op by op, as the
    kernel's epilogue does.  Codes past column i are ignored.  The result
    has x's dtype."""
    K = x.shape[1]
    xq, sx = quantize_acts_int8(x)
    acc = (xq.to(torch.float64) @ wq[:, :K].to(torch.float64).T).float()
    z = acc * sx * scale.to(torch.float32).reshape(1, -1) \
        + b.to(torch.float32)
    return _act_fn(act)(z).to(x.dtype)


# fused_linear_w8a8 (csrc/fused_linear_w8a8.cu): its instances by code,
# rows per block (n8 tiles of 8), m16 tiles of 16 columns
# per block, the k of one fragment chunk, the most blocks of a split of K
# (one portable cluster) and the pad of its partial tile's rows.
# tests/test_torch_kernels.py holds each copy to its source.
W8A8_INSTANCES = {"fused": 0, "pdl": 1}
W8A8_ROWS = (8, 16, 32, 64)
W8A8_TILES = (1, 2, 4, 8)
W8A8_TILE_COLS = 16
W8A8_CHUNK = 64
W8A8_MAX_SPLIT = 8
W8A8_PART_PAD = 4
# The plan's thresholds, from timings on one H100.  The one launch, whose
# every block quantizes its rows whole, takes one n8 tile of rows (B <= 8)
# of at most W8A8_FUSED_MAX_K values: launched from the host as a request
# launches them, it beat the pair over the flagship's three layers at B = 8
# and lost to it at 4096 -> 4096 (chip_smoke.w8a8_direct).  A split of K (a
# cluster barrier and remote reads) only paid where each block still walks
# at least W8A8_SPLIT_MIN_K of k (CUDA-graph sweeps).
W8A8_FUSED_MAX_K = 1024
W8A8_SPLIT_MIN_K = 512


class W8a8Plan(NamedTuple):
    """How ``fused_linear_w8a8`` runs one shape: the instance (``"pdl"``,
    the row quantizer and the product under programmatic dependent launch;
    ``"fused"``, one launch whose blocks quantize their 8 rows themselves),
    rows of x a block takes (the n8 side of the int8 products; the weights
    are always on the m16 side), m16 tiles of 16 columns a block, the grid
    (split, column groups, row tiles), the split of K over the ``split``
    blocks of one cluster with ``kchunk`` k each, shared memory a block,
    and the bytes of scratch (the pdl instance's codes and scales)."""
    instance: str
    rows: int
    tiles: int
    grid: Tuple[int, int, int]
    split: int
    kchunk: int
    smem_bytes: int
    scratch_bytes: int


def w8a8_smem_bytes(instance: str, rows: int, tiles: int, kchunk: int) -> int:
    """Shared memory of one block of ``fused_linear_w8a8``, the formula of
    ``smem_bytes`` in ``csrc/fused_linear_w8a8.cu``: (fused) the block's rows
    of x in f32, the slice's codes (rows padded by 64 bytes when the slice
    is a multiple of 128), the int32 partial tile and the row scales."""
    stride = kchunk if kchunk % 128 else kchunk + 64
    return ((4 * rows * kchunk if instance == "fused" else 0) + rows * stride
            + 4 * rows * (W8A8_TILE_COLS * tiles + W8A8_PART_PAD) + 4 * rows)


def w8a8_plan(B: int, K: int, O: int, sms: int = H100_SMS,
              instance: str = None, *, device_name: str = None) -> W8a8Plan:
    """The plan of ``fused_linear_w8a8`` for x (B, K) and codes (O,
    padded_width(K)), a fixed rule:

    * rows: the least of :data:`W8A8_ROWS` that holds B, else 64 (row tiles);
    * ``"fused"`` where B <= 8 and K <= :data:`W8A8_FUSED_MAX_K`, else
      ``"pdl"``;
    * tiles: the fewest m16 tiles a block (1, 2, 4, 8) that keeps the blocks
      within ``sms``, splits included (8 if none does);
    * split (pdl only; the one launch never splits): over as many blocks as
      the SMs leave room for, at
      most :data:`W8A8_MAX_SPLIT`, each walking at least
      :data:`W8A8_SPLIT_MIN_K` of k; more where a block's codes would not
      fit its shared memory, and then fewer rows a block.

    ``instance`` forces the instance (to time the two designs against each
    other).  Without ``instance``, ``device_name`` takes a tuned entry
    (one of :func:`w8a8_candidates`) in place of the rule.  Raises
    ``ValueError`` for an unknown instance, the one launch at more than 8
    rows, a grid the card cannot launch, a K whose slice does not fit a
    block's shared memory even at 8 rows and the largest split (naming the
    width: K > 230,912 at any B), and a stale tuned entry."""
    if instance is not None and instance not in W8A8_INSTANCES:
        raise ValueError(f"fused_linear_w8a8: unknown instance {instance!r}")
    if B < 1 or K < 1 or O < 1:
        raise ValueError(f"fused_linear_w8a8: empty shape {(B, K, O)}")
    if instance is None:
        tuned = _tuned("linear_w8a8", device_name,
                       lambda: w8a8_candidates(B, K, O, sms), B, K, O)
        if tuned is not None:
            return tuned
    rows = next((r for r in W8A8_ROWS if r >= B), W8A8_ROWS[-1])
    if instance is None:
        instance = ("fused" if rows == W8A8_ROWS[0] and K <= W8A8_FUSED_MAX_K
                    else "pdl")
    if instance == "fused" and rows > W8A8_ROWS[0]:
        raise ValueError(f"fused_linear_w8a8: the one launch takes at most "
                         f"{W8A8_ROWS[0]} rows, not {B}")
    chunks = _cdiv(K, W8A8_CHUNK)
    n16 = _cdiv(O, W8A8_TILE_COLS)

    def fits(r, t, s):
        kc = W8A8_CHUNK * _cdiv(chunks, s)
        return w8a8_smem_bytes(instance, r, t, kc) <= MAX_SMEM_BYTES

    def choose(r, t):
        """(split, blocks) at rows r and tiles t."""
        blocks = _cdiv(n16, t) * _cdiv(B, r)
        s = 1
        if instance == "pdl":
            s = max(1, min(W8A8_MAX_SPLIT, sms // blocks,
                           K // W8A8_SPLIT_MIN_K))
            while not fits(r, t, s) and s < min(W8A8_MAX_SPLIT, chunks):
                s += 1
        return s, blocks * s

    for t in W8A8_TILES:
        s, n = choose(rows, t)
        if n <= sms:
            break
    while not fits(rows, t, s) and rows > W8A8_ROWS[0]:
        rows //= 2
        s, _ = choose(rows, t)
    s = min(max(s, 1), chunks)
    kchunk = W8A8_CHUNK * _cdiv(chunks, s)
    s = _cdiv(chunks, kchunk // W8A8_CHUNK)
    smem = w8a8_smem_bytes(instance, rows, t, kchunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_linear_w8a8: an input width of {K} needs {smem} bytes of "
            f"shared memory per block ({rows} rows x {kchunk} k, split {s} "
            f"ways), more than the {MAX_SMEM_BYTES} one block has")
    gx, gy = _cdiv(n16, t), _cdiv(B, rows)
    if gx > GRID_YZ_MAX or gy > GRID_YZ_MAX:
        raise ValueError(f"fused_linear_w8a8: {B} rows and {O} columns need a "
                         f"grid of {gx} x {gy} blocks, more than "
                         f"{GRID_YZ_MAX} a side")
    return W8a8Plan(instance, rows, t, (s, gx, gy), s, kchunk, smem,
                    B * padded_width(K) + 4 * B if instance == "pdl" else 0)


def _w8a8_free(plan: W8a8Plan) -> list:
    return [plan.instance, plan.rows, plan.tiles, plan.split]


def _dims(widths: Sequence[int]) -> str:
    return "x".join(map(str, widths))


# the JAX package's kernel names, each with its key and free parameters
TUNING: Dict[str, Tuning] = {
    "linear": Tuning(lambda B, K, O, dtype: dict(B=B, K=K, O=O,
                                                 dtype=_dtype_name(dtype)),
                     _linear_free),
    "mlp_fwd": Tuning(lambda B, widths: dict(B=B, dims=_dims(widths)),
                      lambda p: [p.rows]),
    "mlp_train": Tuning(lambda B, widths: dict(B=B, dims=_dims(widths)),
                        lambda g: [g]),
    "linear_w8": Tuning(lambda B, K, O, precision: dict(
        B=B, K=K, O=O, precision=precision), lambda p: [p.instance, p.split]),
    "linear_w8a8": Tuning(lambda B, K, O: dict(B=B, K=K, O=O),
                          _w8a8_free),
    "mlp_w8a8": Tuning(lambda B, N, L: dict(B=B, N=N, L=L),
                       lambda p: [p.rows, p.depth]),
    "rnn_step": Tuning(lambda B, I, O: dict(B=B, I=I, O=O), lambda p: [p]),
}


def w8a8_candidates(B: int, K: int, O: int,
                    sms: int = H100_SMS) -> List[W8a8Plan]:
    """Every plan ``fused_linear_w8a8`` can run at this shape, for the
    tuner: the one launch (B <= 8, no split) and the pair under
    programmatic dependent launch, at each row tile of :data:`W8A8_ROWS`
    from 8 up to the one that holds B, each count of m16 tiles a block, and
    (the pair) K split over 1 to 8 blocks of a cluster; those whose shared
    memory and grid fit, the fixed rule's plan among them."""
    rule = w8a8_plan(B, K, O, sms)
    chunks = _cdiv(K, W8A8_CHUNK)
    n16 = _cdiv(O, W8A8_TILE_COLS)
    top = next((r for r in W8A8_ROWS if r >= B), W8A8_ROWS[-1])
    cands, seen = [], set()
    for instance in ("fused", "pdl"):
        rows_all = ([W8A8_ROWS[0]] if instance == "fused" else
                    [r for r in W8A8_ROWS if r <= top])
        if instance == "fused" and top > W8A8_ROWS[0]:
            continue
        for rows in rows_all:
            for t in W8A8_TILES:
                for want in range(1, (1 if instance == "fused" else
                                      min(W8A8_MAX_SPLIT, chunks)) + 1):
                    kchunk = W8A8_CHUNK * _cdiv(chunks, want)
                    s = _cdiv(chunks, kchunk // W8A8_CHUNK)
                    smem = w8a8_smem_bytes(instance, rows, t, kchunk)
                    gx, gy = _cdiv(n16, t), _cdiv(B, rows)
                    if (smem > MAX_SMEM_BYTES or gx > GRID_YZ_MAX
                            or gy > GRID_YZ_MAX
                            or (instance, rows, t, s) in seen):
                        continue
                    seen.add((instance, rows, t, s))
                    cands.append(W8a8Plan(
                        instance, rows, t, (s, gx, gy), s, kchunk, smem,
                        B * padded_width(K) + 4 * B
                        if instance == "pdl" else 0))
    return _with_rule(cands, rule)


_w8a8_calls: dict = {}  # (B, K, Kp, O, card, plan) -> (plan, entry)
_W8A8_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                  + [ctypes.c_void_p])


def _w8a8_call(B: int, K: int, Kp: int, O: int, dev: int, plan=None):
    """(plan, C entry) of one call shape, cached: ``plan`` (one of
    :func:`w8a8_candidates`) or ``w8a8_plan``'s."""
    key = (B, K, Kp, O, dev, plan)
    call = _w8a8_calls.get(key)
    if call is None:
        sms = _sm_count(dev)
        chosen = (w8a8_plan(B, K, O, sms, device_name=_device_name(dev))
                  if plan is None else _check_plan(
                      "fused_linear_w8a8", plan,
                      w8a8_candidates(B, K, O, sms)))
        call = (chosen,
                _kernel("fused_linear_w8a8", "fused_linear_w8a8_f32",
                        _W8A8_ARGTYPES, keep_gil=True))
        _w8a8_calls[key] = call
    return call


def _fused_linear_w8a8_cuda(x, wq, scale, b, act, plan=None):
    """The kernel: ``w8a8_plan``'s instance, the plan and the C entry cached
    per call shape, the pair's codes and scales kept per card and stream;
    raises ``RuntimeError`` when the C entry refuses the plan or the launch
    fails."""
    B, K, O = _int8_shapes("fused_linear_w8a8", x, wq, scale, b)
    xf, q, s, bf = _int8_operands(x, wq, scale, b)
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0:
        return y.to(x.dtype)
    dev = x.get_device()
    Kp = q.shape[1]
    plan, fn = _w8a8_call(B, K, Kp, O, dev, plan)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    xq = sx = None
    if plan.instance == "pdl":
        xq = _scratch_for("fused_linear_w8a8.codes", dev, stream, B * Kp,
                          torch.int8).data_ptr()
        sx = _scratch_for("fused_linear_w8a8.scales", dev, stream, B,
                          torch.float32).data_ptr()
    err = _launch_on(dev, fn, xf.data_ptr(), q.data_ptr(), s.data_ptr(),
                     bf.data_ptr(), y.data_ptr(), xq, sx, B, K, Kp, O,
                     ACT_CODES[act], W8A8_INSTANCES[plan.instance], plan.rows,
                     plan.tiles, plan.split, plan.kchunk, stream)
    if err:
        _check_launch("fused_linear_w8a8", err)
    _count("fused_linear_w8a8")
    return y.to(x.dtype)


def fused_linear_w8a8(x, wq, scale, b, act: str = "identity",
                      plan: W8a8Plan = None):
    """``act((xq @ wq.T) * sx * sw.T + b)`` with both operands int8 and an
    int32 accumulator; x (B, i) float is quantized per row (``amax / 127``,
    round half to even).  wq (o, i) int8 codes, or (o, padded_width(i))
    with zero codes past i; scale (o, 1) or (o,) f32; b (o,).  On the card
    the products run on the int8 tensor cores in the instance that
    :func:`w8a8_plan` picks: ``"fused"`` (B <= 8, K <= 1,024), one launch
    whose every block quantizes its rows whole before its product, or
    ``"pdl"``, the row quantizer and then the product, launched under
    programmatic dependent launch so that the product issues its weight
    loads before it waits for the codes; K is split over a cluster of up to
    8 blocks where it is long and the blocks few; ``plan`` (one of
    :func:`w8a8_candidates`) replaces the rule's.  On the CPU x is
    quantized by :func:`quantize_acts_int8`, and ``plan`` is ignored."""
    _check_names([act], "default")
    if x.is_cuda:
        run = lambda: _fused_linear_w8a8_cuda(  # noqa: E731
            x, wq, scale, b, act, plan)
        if _nan_checks or _cost_mode is not None:
            return _watched("fused_linear_w8a8", run, fused_linear_w8a8_ref,
                            (x, wq, scale, b, act))
        return run()
    return fused_linear_w8a8_ref(x, wq, scale, b, act)


def fused_mlp_w8a8_forward_ref(x, wqs, sws, bs, hidden_act: str = "relu"):
    """Plain PyTorch whole uniform int8 MLP: the chain of
    :func:`fused_linear_w8a8_ref`, ``hidden_act`` after every layer but the
    last, which gives raw f32 logits."""
    L = wqs.shape[0]
    h = x
    for l in range(L):
        h = fused_linear_w8a8_ref(h, wqs[l], sws[l], bs[l],
                                  hidden_act if l < L - 1 else "identity")
    return h.to(torch.float32)


MLP8_THREADS = 256      # fused_mlp_w8a8_forward: threads per block
MLP8_COLS = 32          # its column tile: output columns a block owns
MLP8_STAGE_K = 1024     # k of one stage of its weight ring, at most
MLP8_MAX_STAGES = 8     # stages of the ring, at most
MLP8_MAX_ROWS = 64      # rows of one group (4 m16 tiles), at most
MLP8_MAX_GRID = 160     # blocks of one launch at most (one per SM)


class MlpW8a8Plan(NamedTuple):
    """How ``fused_mlp_w8a8_forward`` runs a batch: ``groups`` groups of at
    most ``rows`` rows one after another (the weights streamed once per
    group), ``grid`` blocks in one cooperative launch, each owning at most
    ``tiles`` tiles of 32 columns, a ring of ``depth`` stages of ``kc`` k,
    ``smem_bytes`` of shared memory a block."""
    rows: int
    groups: int
    grid: int
    tiles: int
    kc: int
    depth: int
    smem_bytes: int


def mlp_w8a8_smem_bytes(rows: int, kc: int, depth: int, tiles: int) -> int:
    """Shared memory of one block of the whole-MLP int8 kernel, the formula
    of ``smem_bytes`` in ``csrc/fused_mlp_w8a8_forward.cu``: the ring (each
    stage 32 weight rows and the code rows of whole m16 tiles, kc bytes
    each) and 128 bytes to align it, the own columns' f32 values, the eight
    warps' int32 partial m16 tiles (rows of 33), the row scales, and the
    ring's mbarriers and stage numbers."""
    stage = (MLP8_COLS + 16 * _cdiv(rows, 16)) * kc
    return (depth * stage + 128 + 4 * rows * tiles * MLP8_COLS
            + 4 * (MLP8_THREADS // 32) * 16 * (MLP8_COLS + 1)
            + 4 * MLP8_MAX_ROWS + 12 * MLP8_MAX_STAGES)


def mlp_w8a8_plan(B: int, N: int, L: int, sms: int = H100_SMS, *,
                  device_name: str = None) -> MlpW8a8Plan:
    """The whole-MLP int8 kernel's plan for B rows through L layers of
    N x N (N a multiple of 128), a fixed rule: one block per SM, at most one
    per 32-column tile (``grid = min(N / 32, sms)``, each block the tiles
    blk, blk + grid, ...); stages of ``kc = min(N, 1024)`` k; the most rows
    a group (at most 64) whose ring of 2 stages fits one block's shared
    memory, the groups then evened out; and the deepest ring (at most 8
    stages) that fits.  Refuses, naming the width, only what
    :func:`int8_tile_rows` refuses (a row of N codes wider than a block's
    shared memory); every other (B, N) runs, a batch too large for one
    group as several groups in the same launch.  With ``device_name`` a
    tuned entry (one of :func:`mlp_w8a8_candidates`) replaces the rule
    (``ValueError`` for a stale one)."""
    int8_tile_rows(B, N, 1)
    if N % 128 or N < 128 or B < 1 or L < 1:
        raise ValueError(f"fused_mlp_w8a8_forward: B={B}, N={N}, L={L}; "
                         f"needs B, L >= 1 and N a multiple of 128")
    tuned = _tuned("mlp_w8a8", device_name,
                   lambda: mlp_w8a8_candidates(B, N, L, sms), B, N, L)
    if tuned is not None:
        return tuned
    n_tiles = N // MLP8_COLS
    grid = min(n_tiles, sms, MLP8_MAX_GRID)
    tiles = _cdiv(n_tiles, grid)
    kc = min(N, MLP8_STAGE_K)
    rows = min(B, MLP8_MAX_ROWS)
    while rows > 1 and mlp_w8a8_smem_bytes(rows, kc, 2, tiles) > MAX_SMEM_BYTES:
        rows -= 1
    groups = _cdiv(B, rows)
    rows = _cdiv(B, groups)
    depth = 2
    while (depth < MLP8_MAX_STAGES and mlp_w8a8_smem_bytes(
            rows, kc, depth + 1, tiles) <= MAX_SMEM_BYTES):
        depth += 1
    return MlpW8a8Plan(rows, groups, grid, tiles, kc, depth,
                       mlp_w8a8_smem_bytes(rows, kc, depth, tiles))


def mlp_w8a8_candidates(B: int, N: int, L: int,
                        sms: int = H100_SMS) -> List[MlpW8a8Plan]:
    """Plans of the whole-MLP int8 kernel for the tuner: the rule's grid and
    stages, the rows of 1, 2, 4, .. groups (at most 64 rows a group) and
    rings of 2 to 8 stages, those whose shared memory fits, the fixed
    rule's plan among them."""
    rule = mlp_w8a8_plan(B, N, L, sms)
    cands, seen = [], set()
    for groups in _pow2_upto(B):
        rows = _cdiv(B, groups)
        if rows > MLP8_MAX_ROWS or rows in seen:
            continue
        seen.add(rows)
        for depth in range(2, MLP8_MAX_STAGES + 1):
            smem = mlp_w8a8_smem_bytes(rows, rule.kc, depth, rule.tiles)
            if smem <= MAX_SMEM_BYTES:
                cands.append(MlpW8a8Plan(rows, _cdiv(B, rows), rule.grid,
                                         rule.tiles, rule.kc, depth, smem))
    return _with_rule(cands, rule)


_mlp8_calls: dict = {}  # (B, N, L, card, plan) -> (plan, entry)
_MLP8_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])


def _mlp_w8a8_call(B: int, N: int, L: int, dev: int, plan=None):
    """(plan, C entry) of one call shape, cached: ``plan`` (one of
    :func:`mlp_w8a8_candidates`) or ``mlp_w8a8_plan``'s."""
    key = (B, N, L, dev, plan)
    call = _mlp8_calls.get(key)
    if call is None:
        sms = _sm_count(dev)
        chosen = (mlp_w8a8_plan(B, N, L, sms, device_name=_device_name(dev))
                  if plan is None else _check_plan(
                      "fused_mlp_w8a8_forward", plan,
                      mlp_w8a8_candidates(B, N, L, sms)))
        call = (chosen,
                _kernel("fused_mlp_w8a8_forward",
                        "fused_mlp_w8a8_forward_f32", _MLP8_ARGTYPES,
                        keep_gil=True))
        _mlp8_calls[key] = call
    return call


def _mlp_w8a8_launch(plan: MlpW8a8Plan, fn, xf, q, s, bf, y,
                     hidden_act: str, dev: int) -> None:
    """Launches ``plan`` as one cooperative launch (raises ``RuntimeError``
    when the C entry refuses it, the card cannot hold the grid at once or
    the launch fails)."""
    B, N = xf.shape
    stream = torch._C._cuda_getCurrentRawStream(dev)
    act = _scratch_for("fused_mlp_w8a8_forward.codes", dev, stream,
                       plan.rows * N, torch.int8)
    pmax = _scratch_for("fused_mlp_w8a8_forward.pmax", dev, stream,
                        plan.rows * plan.grid, torch.float32)
    err = _launch_on(dev, fn, xf.data_ptr(), q.data_ptr(), s.data_ptr(),
                     bf.data_ptr(), y.data_ptr(), act.data_ptr(),
                     pmax.data_ptr(), B, N, q.shape[0], plan.rows, plan.kc,
                     plan.depth, plan.grid, ACT_CODES[hidden_act], stream)
    if err:
        _check_launch("fused_mlp_w8a8_forward", err)


def _fused_mlp_w8a8_forward_cuda(x, wqs, sws, bs, hidden_act, plan=None):
    """The kernel: ``mlp_w8a8_plan``'s one cooperative launch, the plan and
    the C entry cached per call shape, the scratch kept per card and
    stream."""
    B, N = x.shape
    L = wqs.shape[0]
    if any(t.device != x.device for t in (wqs, sws, bs)):
        raise ValueError("fused_mlp_w8a8_forward: x, wqs, sws and bs must be "
                         "on one device")
    xf = _aligned_f32(x)
    q = wqs.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    s = sws.to(torch.float32).reshape(L, N).contiguous()
    bf = bs.to(torch.float32).reshape(L, N).contiguous()
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0:
        return y
    dev = x.get_device()
    plan, fn = _mlp_w8a8_call(B, N, L, dev, plan)
    _mlp_w8a8_launch(plan, fn, xf, q, s, bf, y, hidden_act, dev)
    _count("fused_mlp_w8a8_forward")
    return y


def fused_mlp_w8a8_forward(x, wqs, sws, bs, hidden_act: str = "relu",
                           plan: MlpW8a8Plan = None):
    """Whole uniform-width int8 MLP: x (B, N) float; wqs (L, N, N) int8
    codes (layer-stacked); sws (L, N) f32 scales; bs (L, N) f32 biases.
    Hidden layers apply ``hidden_act`` and are requantized per row for the
    next layer; the last layer gives raw f32 logits (B, N).  On the card the
    whole forward is one cooperative launch planned by
    :func:`mlp_w8a8_plan`, bit-equal to the chain of
    :func:`fused_linear_w8a8`.  Needs
    N % 128 == 0 (the JAX kernel's rule, on which ``Predictor`` routes);
    other stacks use the per-layer :func:`fused_linear_w8a8`.  ``plan``
    (one of :func:`mlp_w8a8_candidates`) replaces the rule's on the card;
    the plain version ignores it."""
    _check_names([hidden_act], "default")
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_w8a8_forward wants x (B, N), got "
                         f"{tuple(x.shape)}")
    B, N = x.shape
    if (wqs.ndim != 3 or wqs.shape[1] != N or wqs.shape[2] != N or N % 128
            or wqs.dtype != torch.int8):
        raise ValueError(
            f"fused_mlp_w8a8_forward needs uniform 128-multiple dims and "
            f"int8 codes, got x {tuple(x.shape)}, wqs {tuple(wqs.shape)} "
            f"{wqs.dtype}")
    if x.is_cuda:
        run = lambda: _fused_mlp_w8a8_forward_cuda(  # noqa: E731
            x, wqs, sws, bs, hidden_act, plan)
        if _nan_checks or _cost_mode is not None:
            return _watched("fused_mlp_w8a8_forward", run,
                            fused_mlp_w8a8_forward_ref,
                            (x, wqs, sws, bs, hidden_act))
        return run()
    return fused_mlp_w8a8_forward_ref(x, wqs, sws, bs, hidden_act)


# ---------------------------------------------------------------------------
# fused_rnn_step: one Elman step
# ---------------------------------------------------------------------------


def fused_rnn_step_ref(x, s, wx, ws, b, act: str = "logistic"):
    """Plain PyTorch Elman step: ``z = x @ wx.T + s @ ws.T + b`` in f32 (in
    f64 when x is f64, for an exact reference); returns ``(y, s_new) =
    (z, act(z))``, both in x's dtype."""
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    z = x.to(ft) @ wx.to(ft).T + s.to(ft) @ ws.to(ft).T + b.to(ft)
    return z.to(x.dtype), _act_fn(act)(z).to(x.dtype)


def _step_shapes_checked(x, s, wx, ws, b) -> None:
    """Raises ``ValueError`` unless x (B, i), s (B, o), wx (o, i), ws (o,
    o) and b (o,) agree, are f32 and lie on one device."""
    if x.ndim != 2 or s.ndim != 2 or wx.ndim != 2 or ws.ndim != 2 \
            or b.ndim != 1:
        raise ValueError(
            f"fused_rnn_step wants x (B, i), s (B, o), wx (o, i), ws (o, o), "
            f"b (o,); got {tuple(x.shape)}, {tuple(s.shape)}, "
            f"{tuple(wx.shape)}, {tuple(ws.shape)}, {tuple(b.shape)}")
    B, I = x.shape
    O = wx.shape[0]
    if (tuple(s.shape) != (B, O) or wx.shape[1] != I
            or tuple(ws.shape) != (O, O) or b.shape[0] != O):
        raise ValueError(
            f"fused_rnn_step: shapes x {tuple(x.shape)}, s {tuple(s.shape)}, "
            f"wx {tuple(wx.shape)}, ws {tuple(ws.shape)}, b {tuple(b.shape)} "
            f"disagree")
    ts = (x, s, wx, ws, b)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(
            f"fused_rnn_step on CUDA takes float32 operands, got "
            f"{[str(t.dtype) for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("fused_rnn_step: x, s, wx, ws and b must be on one "
                         "device")


def _fused_rnn_step_cuda(x, s, wx, ws, b, act: str):
    _step_shapes_checked(x, s, wx, ws, b)
    B, I = x.shape
    O = wx.shape[0]
    if O > 65535 * 64:
        raise ValueError(f"fused_rnn_step: {O} outputs exceed the grid")
    ts = (x, s, wx, ws, b)
    x, s, wx, ws, b = (t.contiguous() for t in ts)
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    snew = torch.empty_like(y)
    if B == 0 or O == 0:
        return y, snew
    fn = _kernel("fused_rnn_step", "fused_rnn_step_f32",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_p(x), _p(s), _p(wx), _p(ws), _p(b), _p(y), _p(snew), B, I,
                 O, ACT_CODES[act], _stream(x.device))
    _check_launch("fused_rnn_step", err)
    _count("fused_rnn_step")
    return y, snew


class _FusedRNNStep(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU).  Backward:
    plain PyTorch, the math of ``_rnn_step_bwd``:
    ``dz = dy + ds' * act'(z)``; ``dx = dz wx``, ``ds = dz ws``,
    ``dwx = dzᵀ x``, ``dws = dzᵀ s``, ``db = Σ dz``."""

    @staticmethod
    def forward(ctx, x, s, wx, ws, b, act):
        if x.is_cuda:
            run = lambda: _fused_rnn_step_cuda(x, s, wx, ws, b, act)  # noqa: E731
            if _nan_checks or _cost_mode is not None:
                y, snew = _watched("fused_rnn_step", run, fused_rnn_step_ref,
                                   (x, s, wx, ws, b, act))
            else:
                y, snew = run()
        else:
            y, snew = fused_rnn_step_ref(x, s, wx, ws, b, act)
        ctx.save_for_backward(x, s, wx, ws, b, y)
        ctx.act = act
        return y, snew

    @staticmethod
    def backward(ctx, dy, dsnew):
        x, s, wx, ws, b, z = ctx.saved_tensors
        dz = dy + dsnew * _act_grad(ctx.act)(z)
        return (dz @ wx, dz @ ws, dz.T @ x, dz.T @ s, dz.sum(dim=0), None)


def fused_rnn_step(x, s, wx, ws, b, act: str = "logistic",
                   precision: str = "default"):
    """Fused Elman step, batched over sequences: x (B, i), s (B, o), wx
    (o, i), ws (o, o), b (o,) -> ``(y, s_new)``, y the pre-activation
    ``z = x @ wx.T + s @ ws.T + b`` and ``s_new = act(z)``, both (B, o).
    Differentiable (the backward is plain PyTorch); drive it over time with
    a loop for BPTT."""
    _check_names([act], precision)
    return _FusedRNNStep.apply(x, s, wx, ws, b, act)


# ---------------------------------------------------------------------------
# fused_rnn_seq: a whole sequence of Elman steps in one launch
# ---------------------------------------------------------------------------

RNN_SEQ_CLUSTER = 16      # blocks of the sequence kernel's one cluster
RNN_SEQ_THREADS = 1024    # its threads per block (a warp per column)
RNN_SEQ_ROWS = 4          # the rows (B) it takes at most
RNN_SEQ_MAX_O = RNN_SEQ_CLUSTER * RNN_SEQ_THREADS // 32  # a warp per column


def rnn_seq_smem_bytes(B: int, I: int, O: int) -> int:
    """Shared memory of one block of the sequence kernel
    (``seq_smem_floats`` in ``csrc/fused_rnn_step.cu``): its two
    mbarriers, its ``ceil(O / 16)`` columns of ``[Wx | Ws]``, the state
    double-buffered, its biases and its B rows of the new state."""
    cpb = _cdiv(O, RNN_SEQ_CLUSTER)
    return 4 * (4 + cpb * (I + O) + 2 * B * O + cpb + B * cpb)


def _rnn_resident_fits(B: int, I: int, O: int) -> bool:
    if B < 1 or I < 0 or O < 1:
        raise ValueError(f"rnn_seq_plan: no sequence kernel for B={B}, "
                         f"I={I}, O={O}")
    return (B <= RNN_SEQ_ROWS and O <= RNN_SEQ_MAX_O
            and rnn_seq_smem_bytes(B, I, O) <= MAX_SMEM_BYTES)


def rnn_seq_plan(B: int, I: int, O: int, *, device_name: str = None) -> str:
    """How ``fused_rnn_seq`` runs B sequences through an Elman cell I -> O
    on the card, a fixed rule: ``"resident"`` (one launch of the sequence
    kernel, the weights spread over a 16-block cluster's shared memory) when
    B <= 4, O <= 512 (a warp per column) and :func:`rnn_seq_smem_bytes`
    fits one block;
    otherwise ``"steps"`` (one ``fused_rnn_step`` launch per timestep).
    With ``device_name`` a tuned entry (one of :func:`rnn_seq_candidates`)
    replaces the rule.  Raises ``ValueError`` for an empty shape and a
    stale tuned entry."""
    resident = _rnn_resident_fits(B, I, O)
    tuned = _tuned("rnn_step", device_name,
                   lambda: rnn_seq_candidates(B, I, O), B, I, O)
    if tuned is not None:
        return tuned
    return "resident" if resident else "steps"


def rnn_seq_candidates(B: int, I: int, O: int) -> List[str]:
    """The routes a sequence can take at this shape, for the tuner:
    ``"resident"`` where it fits and ``"steps"``."""
    return (["resident"] if _rnn_resident_fits(B, I, O) else []) + ["steps"]


def fused_rnn_seq_ref(xs, s0, wx, ws, b, act: str = "logistic"):
    """Plain PyTorch sequence: the loop of :func:`fused_rnn_step_ref` over
    xs (n, B, i) from s0 (B, o); returns ``(ys, s_final)``, ys (n, B, o) the
    pre-activations."""
    s, ys = s0, []
    for t in range(xs.shape[0]):
        y, s = fused_rnn_step_ref(xs[t], s, wx, ws, b, act)
        ys.append(y)
    if not ys:
        return xs.new_empty((0,) + tuple(s0.shape)), s0.to(xs.dtype)
    return torch.stack(ys), s


_seq_clusters: Dict[tuple, int] = {}
_seq_routes: Dict[tuple, str] = {}  # (B, I, O, card, plan) -> route
_SEQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _seq_cluster_capacity(dev: int, B: int, I: int, O: int) -> int:
    """Clusters of the sequence kernel card ``dev`` holds at once at (B, I,
    O) (``cudaOccupancyMaxActiveClusters``, cached)."""
    key = (dev, B, I, O)
    n = _seq_clusters.get(key)
    if n is None:
        fn = _kernel("fused_rnn_step", "fused_rnn_seq_clusters",
                     [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        _check_launch("fused_rnn_seq clusters",
                      _launch_on(dev, fn, B, I, O, ctypes.byref(out)))
        n = _seq_clusters[key] = out.value
    return n


def _fused_rnn_seq_cuda(xs, s0, wx, ws, b, act: str, plan: str = None):
    """The card's route: ``plan`` (one of :func:`rnn_seq_candidates`) or
    ``rnn_seq_plan``'s, one launch of the sequence kernel or one step
    launch per timestep.  Raises where the plan's launch cannot run (no
    cluster of 16 blocks fits the card, or the launch is refused); it never
    falls back to the plain version."""
    if xs.ndim != 3 or s0.ndim != 2:
        raise ValueError(f"fused_rnn_seq wants xs (n, B, i) and s0 (B, o); "
                         f"got {tuple(xs.shape)}, {tuple(s0.shape)}")
    n, B, I = xs.shape
    if n == 0 or B == 0:
        _step_shapes_checked(xs.new_empty((B, I)), s0, wx, ws, b)
        return xs.new_empty((n, B, wx.shape[0])), s0.clone()
    # one step's checks cover the shapes, dtypes and devices
    _step_shapes_checked(xs[0], s0, wx, ws, b)
    O, dev = wx.shape[0], xs.get_device()
    key = (B, I, O, dev, plan)
    route = _seq_routes.get(key)
    if route is None:
        if plan is None:
            route = rnn_seq_plan(B, I, O, device_name=_device_name(dev))
        else:
            route = _check_plan("fused_rnn_seq", plan,
                                rnn_seq_candidates(B, I, O))
        _seq_routes[key] = route
    if route == "steps":
        s, ys = s0, []
        for t in range(n):
            y, s = _fused_rnn_step_cuda(xs[t], s, wx, ws, b, act)
            ys.append(y)
        return torch.stack(ys), s
    if _seq_cluster_capacity(dev, B, I, O) < 1:
        raise RuntimeError(
            f"fused_rnn_seq: the card cannot hold one cluster of "
            f"{RNN_SEQ_CLUSTER} blocks of {RNN_SEQ_THREADS} threads with "
            f"{rnn_seq_smem_bytes(B, I, O)} bytes of shared memory each")
    xs, s0, wx, ws, b = (t.contiguous() for t in (xs, s0, wx, ws, b))
    ys = xs.new_empty((n, B, O))
    sfin = xs.new_empty((B, O))
    fn = _kernel("fused_rnn_step", "fused_rnn_seq_f32", _SEQ_ARGTYPES,
                 keep_gil=True)
    err = _launch_on(dev, fn, xs.data_ptr(), s0.data_ptr(), wx.data_ptr(),
                     ws.data_ptr(), b.data_ptr(), ys.data_ptr(),
                     sfin.data_ptr(), n, B, I, O, ACT_CODES[act],
                     torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _check_launch("fused_rnn_seq", err)
    _count("fused_rnn_step.seq")
    return ys, sfin


class _FusedRNNSeq(torch.autograd.Function):
    """Forward: the card's route (CUDA) or the plain loop (CPU).  Backward:
    BPTT in plain PyTorch, the per-step math of ``_FusedRNNStep.backward``
    (``dz_t = dy_t + ds_{t+1} act'(z_t)``, ``ds_t = dz_t ws``, ``dx_t =
    dz_t wx``) with the weight gradients summed over time."""

    @staticmethod
    def forward(ctx, xs, s0, wx, ws, b, act, plan):
        if xs.is_cuda:
            run = lambda: _fused_rnn_seq_cuda(  # noqa: E731
                xs, s0, wx, ws, b, act, plan)
            if _nan_checks or _cost_mode is not None:
                ys, sfin = _watched("fused_rnn_seq", run, fused_rnn_seq_ref,
                                    (xs, s0, wx, ws, b, act))
            else:
                ys, sfin = run()
        else:
            ys, sfin = fused_rnn_seq_ref(xs, s0, wx, ws, b, act)
        ctx.save_for_backward(xs, s0, wx, ws, b, ys)
        ctx.act = act
        return ys, sfin

    @staticmethod
    def backward(ctx, dys, dsfin):
        xs, s0, wx, ws, b, zs = ctx.saved_tensors
        n = xs.shape[0]
        act_grad = _act_grad(ctx.act)
        ds, dzs = dsfin, [None] * n
        for t in range(n - 1, -1, -1):
            dz = dys[t] + ds * act_grad(zs[t])
            dzs[t] = dz
            ds = dz @ ws
        if n == 0:
            return (xs.new_zeros(xs.shape), ds, torch.zeros_like(wx),
                    torch.zeros_like(ws), torch.zeros_like(b), None, None)
        dz = torch.stack(dzs)                      # (n, B, o)
        # the states s_0 .. s_{n-1} the steps read
        states = torch.cat([s0[None].to(zs.dtype),
                            _act_fn(ctx.act)(zs[:-1])])
        flat = dz.reshape(-1, dz.shape[-1])
        return (dz @ wx, ds, flat.T @ xs.reshape(-1, xs.shape[-1]),
                flat.T @ states.reshape(-1, states.shape[-1]),
                flat.sum(dim=0), None, None)


def fused_rnn_seq(xs, s0, wx, ws, b, act: str = "logistic",
                  precision: str = "default", plan: str = None):
    """A whole Elman sequence: xs (n, B, i), s0 (B, o), wx (o, i), ws (o,
    o), b (o,) -> ``(ys, s_final)``, ys (n, B, o) the pre-activations
    ``z_t = x_t @ wx.T + s_t @ ws.T + b`` and ``s_{t+1} = act(z_t)``.  On
    the card, :func:`rnn_seq_plan` picks one launch for the sequence (counted
    as ``fused_rnn_step.seq``) or one ``fused_rnn_step`` launch per step;
    on the CPU it is the plain loop.  ``plan`` (``"resident"`` or
    ``"steps"``, one of :func:`rnn_seq_candidates`) replaces the rule's on
    the card.  Differentiable (BPTT in plain PyTorch)."""
    _check_names([act], precision)
    return _FusedRNNSeq.apply(xs, s0, wx, ws, b, act, plan)
