"""The port's kernels, each written by hand in CUDA C++ for Hopper and kept
beside its plain PyTorch version.

* :func:`fused_linear` — ``act(x @ w.T + b)`` (``csrc/fused_linear.cu``),
  the port of the TPU kernel ``_linear_act_kernel``, for f32 operands or,
  with bf16 ``x``, bf16 operands and y (f32 accumulation), with its
  backward in plain PyTorch as the JAX package's backward is plain XLA.
  :func:`linear_plan` picks one of its three instances per shape.
* :func:`fused_mlp_forward` — a whole ffLayer chain with an optional
  softmax output in one launch (``csrc/fused_mlp_forward.cu``), the port of
  the TPU kernel ``_mlp_kernel``.
* :func:`fused_mlp_train_step` — one whole SGD step (forward, loss,
  backward, update) in one cooperative launch whose stages
  (:func:`train_stages`) each spread over the whole card
  (``csrc/fused_mlp_train_step.cu``), the port of the TPU kernel
  ``_mlp_train_kernel``.
* :func:`fused_linear_w8` — weight-only int8 ``act(x @ (q * s).T + b)``
  (``csrc/fused_linear_w8.cu``), the port of ``_linear_w8_kernel``.
* :func:`fused_linear_w8a8` — int8 x int8 -> int32 ``act((q(x) @ q.T) * sx
  * sw.T + b)`` (``csrc/fused_linear_w8a8.cu``), the port of
  ``_linear_w8a8_kernel``: one launch quantizes the rows of x, a second
  takes the product.
* :func:`fused_mlp_w8a8_forward` — a whole uniform-width int8 MLP from one
  call, each layer a requantizing launch and a product launch
  (``csrc/fused_mlp_w8a8_forward.cu``), the port of ``_mlp_w8a8_kernel``.
* :func:`fused_rnn_step` — one Elman step ``z = x @ wx.T + s @ ws.T + b``,
  ``(y, s') = (z, act(z))`` (``csrc/fused_rnn_step.cu``), the port of
  ``_rnn_step_kernel``, with its backward in plain PyTorch as the JAX
  package's VJP is plain XLA.

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

import ctypes
import threading
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

ACT_CODES = {"identity": 0, "logistic": 1, "relu": 2, "tanh": 3}
PRECISIONS = ("default", "highest")
MAX_SMEM_BYTES = 227 * 1024  # dynamic shared memory one H100 block may use
MAX_TILE_ROWS = 32           # fused_mlp_forward: one partial sum per lane
MAX_LAYERS = 16              # whole-chain kernels: layers in one launch
LOSS_KINDS = {"softmax_xent": 0, "squared_error": 1}
H100_SMS = 132               # streaming multiprocessors of one H100

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {"fused_linear": 0, "fused_mlp_forward": 0,
                             "fused_mlp_train_step": 0, "fused_linear_w8": 0,
                             "fused_linear_w8a8": 0,
                             "fused_mlp_w8a8_forward": 0,
                             "fused_rnn_step": 0,
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


def _count(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


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


def linear_plan(B: int, K: int, O: int, dtype=torch.float32,
                aligned: bool = True, sms: int = H100_SMS) -> LinearPlan:
    """The instance of ``fused_linear`` for x (B, K), w (O, K), a fixed
    rule (not an autotuner):

    * B <= 16: ``gemv``, one warp per output column, 4 columns a block;
    * at least ``sms`` 128 x 128 output tiles: ``large``;
    * otherwise ``tile`` (32 x 64 output tiles); where the tiles are fewer
      than ``sms`` and K > 64, K is split over enough blocks to give every
      SM one (each split walking at least 64 k, a multiple of 16), the
      partials added in split order by the last block of each tile.

    ``vec`` (16-byte loads) needs K % 4 == 0 and ``aligned`` operands (x
    and w 4-element aligned); otherwise the same instance loads scalars.
    f32 and bf16 operands take the same plan.  Raises ``ValueError`` for a
    dtype the kernel does not take or a grid the card cannot launch."""
    if dtype not in _LINEAR_ENTRIES:
        raise ValueError(f"fused_linear on CUDA takes float32 or bfloat16 "
                         f"x, got {dtype}")
    vec = K % 4 == 0 and aligned
    if B <= GEMV_ROWS[-1]:
        rows = next(r for r in GEMV_ROWS if r >= B)
        return LinearPlan("gemv", vec, rows, (_cdiv(O, GEMV_WARPS), 1, 1),
                          LINEAR_INSTANCES["gemv"][2], 1, max(K, 1), 0)
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
    split, kchunk = 1, max(K, 1)
    if instance == "tile" and gx * gy < sms and K > SPLIT_MIN_K:
        bk = LINEAR_INSTANCES["tile"][1][2]
        split = min(_cdiv(sms, gx * gy), _cdiv(K, SPLIT_MIN_K))
        kchunk = _cdiv(_cdiv(K, split), bk) * bk
        split = _cdiv(K, kchunk)
    return LinearPlan(instance, vec, bm, (gx, gy, split),
                      LINEAR_INSTANCES[instance][2], split, kchunk,
                      split * B * O if split > 1 else 0)


_linear_calls: dict = {}  # (B, K, O, dtype, aligned, card) -> (plan, entry)
_LINEAR_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                    + [ctypes.c_void_p] * 3)


def _fused_linear_cuda(x, w, b, act: str, save_z: bool):
    """The kernel: f32 x with f32 operands, or bf16 x with bf16 operands (w
    rounded to bf16 as the plain version rounds it); f32 accumulation, b
    and z f32, y in x's dtype.  The instance is ``linear_plan``'s, cached
    per call shape."""
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
    key = (B, K, O, x.dtype, aligned, dev)
    call = _linear_calls.get(key)
    if call is None:
        call = (linear_plan(B, K, O, x.dtype, aligned, _sm_count(dev)),
                _kernel("fused_linear", entry, _LINEAR_ARGTYPES,
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
    def forward(ctx, x, w, b, act, save_z):
        if x.is_cuda:
            y, z = _fused_linear_cuda(x, w, b, act, save_z)
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
        return dx, dw, db, None, None


def fused_linear(x, w, b, act: str = "identity", precision: str = "default"):
    """``act(x @ w.T + b)``: x (B, i), w (o, i) in the ffLayer layout
    (``FeedForward.hs:209-213``), b (o,).  Differentiable; the forward
    keeps the f32 pre-activation only when a gradient will be taken."""
    _check_names([act], precision)
    save_z = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, b))
    return _FusedLinear.apply(x, w, b, act, save_z)


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


def tile_rows(batch: int, widths: Sequence[int]) -> int:
    """Batch rows per block of the whole-chain kernel: as many as let two
    ``rows x stride`` f32 activation buffers fit in one block's shared
    memory, at most :data:`MAX_TILE_ROWS`.  Raises ``ValueError`` when not
    even one row fits."""
    widest = max(widths)
    stride = widest | 1
    per_row = 2 * stride * 4
    fit = MAX_SMEM_BYTES // per_row
    if fit < 1:
        raise ValueError(
            f"fused_mlp_forward: a layer width of {widest} needs {per_row} "
            f"bytes of shared memory per batch row, more than the "
            f"{MAX_SMEM_BYTES} one block has")
    return max(1, min(batch, MAX_TILE_ROWS, fit))


def _fused_mlp_forward_cuda(x, weights, biases, acts, softmax_out):
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
    B = x.shape[0]
    rows = tile_rows(B, dims)
    xf = x.to(torch.float32).contiguous()
    ws = [w.to(torch.float32).contiguous() for w in weights]
    bs = [b.to(torch.float32).contiguous() for b in biases]
    y = torch.empty((B, dims[-1]), dtype=torch.float32, device=x.device)
    if B == 0:
        return y.to(x.dtype)
    fn = _kernel("fused_mlp_forward", "fused_mlp_forward_f32",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    w_ptrs = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
    b_ptrs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_acts = (ctypes.c_int * n)(*(ACT_CODES[a] for a in acts))
    with torch.cuda.device(x.device):
        err = fn(_p(xf), _p(y), B, rows, n, w_ptrs, b_ptrs, c_dims, c_acts,
                 int(bool(softmax_out)), max(dims) | 1, _stream(x.device))
    _check_launch("fused_mlp_forward", err)
    _count("fused_mlp_forward")
    return y.to(x.dtype)


def fused_mlp_forward(x, weights, biases, acts: Sequence[str],
                      softmax_out: bool = True, precision: str = "default"):
    """Whole ffLayer-chain forward in ONE kernel launch: one block per
    batch tile, the tile's activations in shared memory across layers,
    the weights streamed from L2.

    weights[k]: (o_k, i_k) with i_{k+1} == o_k; acts[k] applied after
    layer k (the last layer uses a softmax over its real width when
    ``softmax_out``).  Weights of any float dtype are read as f32.  The
    batch tile is chosen by :func:`tile_rows`."""
    if not (len(weights) == len(biases) == len(acts)) or not weights:
        raise ValueError("fused_mlp_forward: need one weight, bias and "
                         "activation per layer")
    _check_names(acts, precision)
    if x.is_cuda:
        return _fused_mlp_forward_cuda(x, weights, biases, acts, softmax_out)
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
               widths: Sequence[int]) -> int:
    """The step kernel's grid: one block per SM (``sms``), at most the
    blocks the card holds at once (``capacity``), since the stages meet at
    grid barriers, whose cost grows with the blocks that meet (a second
    block per SM made the step slower on the H100).  Raises ``ValueError``
    naming the shapes when the card holds none."""
    if capacity < 1:
        raise ValueError(
            f"fused_mlp_train_step: the card cannot hold a cooperative grid "
            f"of the step kernel ({capacity} co-resident blocks of "
            f"{TRAIN_THREADS} threads) for widths "
            f"{'-'.join(map(str, widths))} at batch {batch}")
    return min(capacity, sms)


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


def _fused_mlp_train_step_cuda(x, y, weights, biases, lr, acts, loss_kind):
    """The kernel: one cooperative launch with a grid barrier between each
    two of :func:`train_stages`."""
    dims = _train_step_widths(x, y, weights, biases)
    n, batch, dev = len(weights), x.shape[0], x.get_device()
    grid = train_grid(_train_step_capacity(dev), _sm_count(dev), batch,
                      dims)
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
                 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_acts = (ctypes.c_int * n)(*(ACT_CODES[a] for a in acts))
    err = _launch_on(dev, fn, xf.data_ptr(), yf.data_ptr(), batch, n,
                     ptrs(ws), ptrs(bs), ptrs(new_ws), ptrs(new_bs), c_dims,
                     c_acts, LOSS_KINDS[loss_kind], float(lr),
                     scratch.data_ptr(), part.data_ptr(), counters.data_ptr(),
                     part_cap, loss.data_ptr(), int(vec), grid, stream)
    _check_launch("fused_mlp_train_step", err)
    _count("fused_mlp_train_step")
    return (loss,
            [nw.to(w.dtype) for nw, w in zip(new_ws, weights)],
            [nb.to(b.dtype) for nb, b in zip(new_bs, biases)])


def fused_mlp_train_step(x, y, weights, biases, lr, acts: Sequence[str],
                         precision: str = "default",
                         loss_kind: str = "softmax_xent"):
    """One whole SGD step of an ffLayer chain: forward, loss, backward and
    ``w -= lr * g``, in one cooperative launch over the whole card.

    x (B, i), y (B, o) targets, weights[k] (o_k, i_k), biases[k] (o_k,).
    ``loss_kind="softmax_xent"`` (the flagship): softmax output and
    cross-entropy, ``acts[-1]`` ignored; ``"squared_error"``: ``acts[-1]``
    output and squared error summed over the outputs (pass ``y = x`` for an
    autoencoder).  Both are meaned over the batch.  Returns ``(loss,
    new_weights, new_biases)``; the loss is a 0-d f32 tensor on x's
    device.  On the card the stages are :func:`train_stages`."""
    if not (len(weights) == len(biases) == len(acts)) or not weights:
        raise ValueError("fused_mlp_train_step: need one weight, bias and "
                         "activation per layer")
    _check_names(acts, precision)
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss_kind {loss_kind!r} "
                         f"(known: {sorted(LOSS_KINDS)})")
    if x.is_cuda:
        return _fused_mlp_train_step_cuda(x, y, weights, biases, lr, acts,
                                          loss_kind)
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
    """Batch rows per block of an int8 kernel: the power of two that covers
    the batch, at most :data:`INT8_MAX_TILE_ROWS`, halved until the rows'
    ``k_padded`` values of ``bytes_per_value`` bytes (codes for w8a8, f32
    for w8) fit one block's shared memory.  Raises ``ValueError`` when not
    even one row fits."""
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


def _fused_linear_w8_cuda(x, wq, scale, b, act, precision):
    B, K, O = _int8_shapes("fused_linear_w8", x, wq, scale, b)
    xf, q, s, bf = _int8_operands(x, wq, scale, b)
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0:
        return y.to(x.dtype)
    Kp = q.shape[1]
    rows = int8_tile_rows(B, Kp, 4)
    fn = _kernel("fused_linear_w8", "fused_linear_w8_f32",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_p(xf), _p(q), _p(s), _p(bf), _p(y), B, K, Kp, O, rows,
                 ACT_CODES[act], int(precision == "highest"),
                 _stream(x.device))
    _check_launch("fused_linear_w8", err)
    _count("fused_linear_w8")
    return y.to(x.dtype)


def fused_linear_w8(x, wq, scale, b, act: str = "identity",
                    precision: str = "default"):
    """``act(x @ (wq * scale).T + b)`` with int8 weights dequantized in the
    kernel.  x (B, i); wq (o, i) int8 codes, or (o, padded_width(i)) with
    zero codes past i (:func:`pad_codes`); scale (o, 1) or (o,) f32; b
    (o,).  Not differentiable (a serving kernel)."""
    _check_names([act], precision)
    if x.is_cuda:
        return _fused_linear_w8_cuda(x, wq, scale, b, act, precision)
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


def _fused_linear_w8a8_cuda(x, wq, scale, b, act):
    B, K, O = _int8_shapes("fused_linear_w8a8", x, wq, scale, b)
    xf, q, s, bf = _int8_operands(x, wq, scale, b)
    y = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0:
        return y.to(x.dtype)
    Kp = q.shape[1]
    rows = int8_tile_rows(B, Kp, 1)
    xq = torch.empty((B, Kp), dtype=torch.int8, device=x.device)
    sx = torch.empty(B, dtype=torch.float32, device=x.device)
    fn = _kernel("fused_linear_w8a8", "fused_linear_w8a8_f32",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_p(xf), _p(q), _p(s), _p(bf), _p(y), _p(xq), _p(sx), B, K,
                 Kp, O, rows, ACT_CODES[act], _stream(x.device))
    _check_launch("fused_linear_w8a8", err)
    _count("fused_linear_w8a8")
    return y.to(x.dtype)


def fused_linear_w8a8(x, wq, scale, b, act: str = "identity"):
    """``act((xq @ wq.T) * sx * sw.T + b)`` with both operands int8 and an
    int32 accumulator; x (B, i) float is quantized per row by a CUDA pass of
    its own before the product (on the CPU by :func:`quantize_acts_int8`).  wq (o, i) int8
    codes, or (o, padded_width(i)) with zero codes past i; scale (o, 1) or
    (o,) f32; b (o,)."""
    _check_names([act], "default")
    if x.is_cuda:
        return _fused_linear_w8a8_cuda(x, wq, scale, b, act)
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


def _fused_mlp_w8a8_forward_cuda(x, wqs, sws, bs, hidden_act):
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
    hbuf = torch.empty((2, B, N), dtype=torch.float32, device=x.device)
    xq = torch.empty((B, N), dtype=torch.int8, device=x.device)
    sx = torch.empty(B, dtype=torch.float32, device=x.device)
    rows = int8_tile_rows(B, N, 1)
    fn = _kernel("fused_mlp_w8a8_forward", "fused_mlp_w8a8_forward_f32",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(_p(xf), _p(q), _p(s), _p(bf), _p(y), _p(hbuf), _p(xq),
                 _p(sx), B, N, L, rows, ACT_CODES[hidden_act],
                 _stream(x.device))
    _check_launch("fused_mlp_w8a8_forward", err)
    _count("fused_mlp_w8a8_forward")
    return y


def fused_mlp_w8a8_forward(x, wqs, sws, bs, hidden_act: str = "relu"):
    """Whole uniform-width int8 MLP: x (B, N) float; wqs (L, N, N) int8
    codes (layer-stacked); sws (L, N) f32 scales; bs (L, N) f32 biases.
    Hidden layers apply ``hidden_act`` and are requantized per row for the
    next layer; the last layer gives raw f32 logits (B, N).  Needs
    N % 128 == 0 (the JAX kernel's rule, on which ``Predictor`` routes);
    other stacks use the per-layer :func:`fused_linear_w8a8`."""
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
        return _fused_mlp_w8a8_forward_cuda(x, wqs, sws, bs, hidden_act)
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


def _fused_rnn_step_cuda(x, s, wx, ws, b, act: str):
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
    if O > 65535 * 64:
        raise ValueError(f"fused_rnn_step: {O} outputs exceed the grid")
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
            y, snew = _fused_rnn_step_cuda(x, s, wx, ws, b, act)
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
