"""Engine: cached callables for whole op graphs, and the port's ``jax.jit``.

The JAX package traces each graph once per (graph, backend, mode) into one
jitted XLA program, compiled once per input shape.  Here :func:`maybe_jit`
(and :func:`jit`, for the models that carry no backend) returns a
:class:`Compiled`: on the card it captures ONE CUDA graph per call
signature (the input tensors' shapes and dtypes, the non-tensor arguments
that fix the program and the kernels' plan epoch) and replays it on every
later call of that signature.  A call copies its inputs into the graph's
static buffers, replays, and returns copies of the outputs, which the
caller owns: a value returned earlier is never overwritten.  Every float
argument is traced, as JAX traces a rate: it enters the graph as a 0-d
tensor in a static buffer, so a new rate never recaptures, except beside a
bf16 or f16 tensor, where the graph keys on the float's value to stay
bit-equal to the direct call (:func:`_traces_floats`).  The arguments a
:class:`Compiled` is told to read in place (a model's weights) are no
graph inputs: the graph reads them where they lie and keys on their
addresses, with no copy.  The first call of
a signature runs the function direct (the capture's warm-up, whose
results it returns) and captures it; the kernel launches a replay holds are
counted at every replay, so a call counts what a direct call counts.
:class:`Loop` is the port's ``lax.scan`` / ``fori_loop`` over one such
graph: one step captured and replayed ``n`` times, its carry updated in
place on the card.

The graphs of a callable sit in an ``ir.CompiledCache`` (an LRU of 128),
all of them in one memory pool per card, and replay in order on one stream
per card (their temporaries may share memory; their outputs are copied into
buffers of their own inside the graph).  One lock a graph guards its
buffers.  A capture that fails raises :class:`CaptureError` naming the
operation: a compiled call on the card never runs direct in its place.

The capture itself (:func:`capture`, :class:`Captured`, the trees of
:func:`flatten`) lives here and serves the models' graphs too: the chained
training windows (``models/chain.py``) and the request graphs
(``models/serve.py``).  Every :class:`Captured` graph of a card, a request
graph or a compiled call, is captured on the card's one capture stream and
replays on its one replay stream, where the warm-ups run (:func:`_card`).

These calls run direct, by rule: a call with no tensor on the card (CPU
tensors; the NumPy backend is never compiled), one with a
``parallel.mesh.Sharded`` leaf (a mesh runs unchained), one under
``utils.profiling.enable_nan_checks`` or another dispatch mode
(``cost_analysis`` counts the function's own work), one that autograd
records (an input that requires grad under grad mode, or a ``torch.func``
transform's tensor), one while the stream captures, and one inside
:func:`direct`, which another graph's warm-up and capture enter
(:class:`Captured`: a compiled call inside is inlined into that graph).
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from .backend.base import Backend
from .ops import ir
from .ops import kernels as K
from .ops.ir import TOp


def _key(be: Backend, mode: str) -> tuple:
    return be.cache_key() + (mode,)


def compile_run(op: TOp, be: Backend) -> Callable:
    """Forward: ``fn(*xs) -> ys_tuple``."""
    key = _key(be, "run")
    fn = op._compiled.get(key)
    if fn is None:

        def fwd(*xs):
            return op.apply(be, tuple(xs))

        fn = maybe_jit(fwd, be, f"the forward of {type(op).__name__}")
        op._compiled[key] = fn
    return fn


def compile_grad(op: TOp, be: Backend) -> Callable:
    """Gradient of a scalar-output graph: ``fn(*xs) -> grads_tuple``
    (the staged ``gradTOp``)."""
    key = _key(be, "grad")
    fn = op._compiled.get(key)
    if fn is None:

        def gradf(*xs):
            return ir.grad(op, be, xs)

        fn = maybe_jit(gradf, be, f"the gradient of {type(op).__name__}")
        op._compiled[key] = fn
    return fn


def compile_value_and_grad(op: TOp, be: Backend) -> Callable:
    key = _key(be, "vag")
    fn = op._compiled.get(key)
    if fn is None:

        def vag(*xs):
            return ir.value_and_grad(op, be, xs)

        fn = maybe_jit(vag, be,
                       f"the value and gradient of {type(op).__name__}")
        op._compiled[key] = fn
    return fn


def compile_vjp(op: TOp, be: Backend) -> Callable:
    """General VJP: ``fn(xs_tuple, cts_tuple) -> grads_tuple``."""
    key = _key(be, "vjp")
    fn = op._compiled.get(key)
    if fn is None:

        def vjpf(xs, cts):
            return ir.vjp(op, be, xs, cts)

        fn = maybe_jit(vjpf, be, f"the VJP of {type(op).__name__}")
        op._compiled[key] = fn
    return fn


def maybe_jit(fn: Callable, be: Backend, what: str = "a compiled call"
              ) -> Callable:
    """``fn`` compiled for a torch backend (:class:`Compiled`: one CUDA
    graph per call signature on the card, direct on the CPU); the identity
    for the NumPy oracle."""
    if be.name == "numpy":
        return fn
    return jit(fn, what)


def jit(fn: Callable, what: str = "a compiled call",
        in_place: Sequence[int] = ()) -> "Compiled":
    """:class:`Compiled` of ``fn``; ``what`` names it in a capture error;
    ``in_place`` the positions of the arguments whose tensors the graph
    reads where they lie (:class:`Compiled`)."""
    return Compiled(fn, what, in_place)


# ---------------------------------------------------------------------------
# capture: the trees of a call, one function in a CUDA graph, the cards'
# streams (shared by the models' graphs: models/chain.py, models/serve.py)
# ---------------------------------------------------------------------------

def uses_graphs(device) -> bool:
    """Whether a graph's call on ``device`` (a compiled call, a chained
    window, a request) replays a CUDA graph."""
    return torch.device(device).type == "cuda"


def flatten(tree) -> List[Any]:
    """The leaves of a tree of tuples and lists (``None`` is empty), in
    order: a call's arguments, the training state ``(params, opt_state,
    ema)``."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [tree]


def unflatten(template, leaves: Sequence[Any]):
    """Rebuild ``template``'s structure from ``leaves`` (flatten's order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


class CaptureError(RuntimeError):
    """A function could not be captured in a CUDA graph."""


def _failing_op(err: BaseException) -> str:
    """``function (file:line: code)`` of the innermost frame of ``err``'s
    traceback outside torch and outside this module: the operation of the
    captured function (or of a caller's optimizer) that broke capture."""
    here = os.path.abspath(__file__)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    frames = traceback.extract_tb(err.__traceback__)
    own = [f for f in frames if os.path.abspath(f.filename) != here
           and not os.path.abspath(f.filename).startswith(torch_dir)]
    f = (own or frames)[-1]
    return f"{f.name} ({f.filename}:{f.lineno}: {(f.line or '').strip()})"


def capture(fn: Callable[[bool], Any], device,
            what: str = "the training step",
            remedy: str = ("a chained window is never run eagerly on the "
                           "card; pass chain_steps=1 to train unchained"),
            streams: Optional[tuple] = None,
            pool=None) -> "torch.cuda.CUDAGraph":
    """Run ``fn(False)`` once (warm-up: cuBLAS handles, kernel modules and
    the caching allocator's blocks), then capture one call of ``fn(True)``
    into a new CUDA graph and return it.

    ``streams`` is ``(warm-up stream, capture stream)`` (:class:`Captured`
    passes its card's).  Without it a full garbage collection runs first,
    which frees the graphs and blocks of earlier chained windows, the
    warm-up runs on a new side stream and the capture on torch's own.  A
    caller that passes ``streams`` holds no reference cycle over its graphs
    and gets no collection (it would stall every other thread).

    torch keeps one cuBLAS workspace per (handle, stream) and never frees
    it here: a graph's cuBLAS calls write the workspace of its capture
    stream, made by the first capture on that stream; dropping the
    workspaces around a capture (torch's ``_cuda_clearCublasWorkspaces``)
    freed memory that later graphs read.  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) puts the graph's memory in a pool
    other graphs share; without it the graph has a pool of its own.
    Raises :class:`CaptureError` naming ``what`` was captured, the
    operation that broke capture and the caller's ``remedy``."""
    device = torch.device(device)
    # a collection inside the capture could destroy an unreachable graph,
    # which a capturing stream refuses (the capture is then invalidated):
    # collect first (unless the caller's graphs hold no cycles), and never
    # during it
    if streams is None:
        gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        cur = torch.cuda.current_stream(device)
        warm, on = streams if streams is not None else (
            torch.cuda.Stream(device), None)
        warm.wait_stream(cur)
        with torch.cuda.stream(warm):
            fn(False)
        cur.wait_stream(warm)
        graph = torch.cuda.CUDAGraph()
        kw = {} if on is None else {"stream": on}
        if pool is not None:
            kw["pool"] = pool
        with torch.cuda.graph(graph, capture_error_mode="thread_local",
                              **kw):
            fn(True)
        torch.cuda.synchronize(device)
    except Exception as err:  # noqa: BLE001 — re-raised with its site
        raise CaptureError(
            f"capturing {what} in a CUDA graph failed at "
            f"{_failing_op(err)}: {type(err).__name__}: {err} — "
            f"{remedy}") from err
    finally:
        if collecting:
            gc.enable()
    return graph


# one capture at a time in the process: the card's capture stream is shared
# and the scratch a capture takes is found by its stream
_capture_lock = threading.RLock()
_per_card: Dict[torch.device, tuple] = {}


def _card(device: torch.device) -> tuple:
    """(capture stream, replay stream, memory pool) of ``device``: None for
    each off the card (where :func:`capture` is a stand-in).

    Every :class:`Captured` graph on a card is captured on its capture
    stream, which runs nothing else, and replays on its replay stream, where
    warm-ups run too.  So the graphs' cuBLAS calls write the capture
    stream's workspace (per thread's handle), which no direct call writes,
    and they write it one graph at a time: replays and warm-ups take turns
    in one stream's order.  Both streams are of high priority, a pool of
    streams that nothing else in the port asks for (torch hands its pooled
    streams out again after 32 requests)."""
    got = _per_card.get(device)
    if got is None:
        with _capture_lock:
            got = _per_card.get(device)
            if got is None:
                got = _per_card[device] = (_card_streams(device)
                                           if device.type == "cuda"
                                           else (None, None, None))
    return got[:3]


def _card_streams(device: torch.device) -> tuple:
    """A card's capture and replay streams, its pool, and the pool's
    anchor (:func:`_anchor`)."""
    on = torch.cuda.Stream(device, priority=-1)
    replay = torch.cuda.Stream(device, priority=-1)
    pool = torch.cuda.graph_pool_handle()
    return on, replay, pool, _anchor(device, on, pool)


def _anchor(device: torch.device, stream, pool) -> "torch.cuda.CUDAGraph":
    """A graph of one fill captured in ``pool`` on ``stream``, kept for the
    process's life.  A capture can leave blocks in the pool that outlive
    its graph (the capture stream's cuBLAS workspace, made at the first
    cuBLAS call on it); once every graph of a pool is gone, the caching
    allocator refuses a new capture into a pool that still holds blocks,
    so one graph stays."""
    anchor = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.graph(anchor, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        torch.zeros(1, device=device)
    return anchor


class Captured:
    """``fn(commit)`` captured in a CUDA graph (:func:`capture`) on its
    card's capture stream, warmed up and replayed on the card's replay
    stream (:func:`_card`): ``fn(False)`` is the warm-up, ``fn(True)`` the
    call the graph holds.  Keeps the hand-written kernel launches the
    captured call made (``kernels.held_launches``), which :meth:`replay`
    counts on every replay as a direct call counts them, and the scratch
    those kernels write (``kernels.take_scratch``): no later launch on the
    capture stream can replace a buffer the graph's kernels write.  Both
    calls of ``fn`` run under :func:`direct`: a compiled call inside takes
    its work into this graph, as ``jax.jit`` inlines a jitted function it
    traces.  ``lock`` is for the owner's static buffers, which a replay
    reads and writes, and the replay's events; ``pool`` as in
    :func:`capture`."""

    def __init__(self, fn: Callable[[bool], Any], device, what: str,
                 remedy: str, pool=None):
        self.launches: Dict[str, int] = {}
        self.lock = threading.Lock()

        def body(commit: bool) -> None:
            with direct():
                if not commit:
                    fn(False)
                    return
                with K.held_launches() as held:
                    fn(True)
                self.launches = held

        device = torch.device(device)
        on, self.stream, _ = _card(device)
        self.events = (None if self.stream is None else
                       (torch.cuda.Event(), torch.cuda.Event()))
        kw = {} if pool is None else {"pool": pool}
        with _capture_lock:
            self.graph = capture(
                body, device, what=what, remedy=remedy,
                streams=None if on is None else (self.stream, on), **kw)
            self.scratch = [] if on is None else K.take_scratch(
                on.cuda_stream)

    def replay(self, n: int = 1) -> None:
        """Replay ``n`` times on the replay stream, ordered after the
        caller's stream and before its later work."""
        if self.stream is None:
            for _ in range(n):
                self.graph.replay()
        else:
            cur = torch.cuda.current_stream(self.stream.device)
            before, after = self.events
            before.record(cur)
            self.stream.wait_event(before)
            with torch.cuda.stream(self.stream):
                for _ in range(n):
                    self.graph.replay()
            after.record(self.stream)
            cur.wait_event(after)
        for _ in range(n):
            K.count_launches(self.launches)


# ---------------------------------------------------------------------------
# the rules, the pool, the counts
# ---------------------------------------------------------------------------

_REMEDY = ("a compiled call on the card never runs direct in its place; "
           "pass CPU tensors to run it on the CPU")
_COUNTS = {"captures": 0, "capture_s": 0.0, "replays": 0}
_counts_lock = threading.Lock()
_direct = threading.local()


def graph_counts() -> dict:
    """``{"captures", "capture_s", "replays"}`` of this process's compiled
    calls: graphs captured, the host seconds their warm-up and capture
    took, and graph replays (a loop's ``n - 1`` replays count each)."""
    with _counts_lock:
        return dict(_COUNTS)


def reset_graph_counts() -> None:
    with _counts_lock:
        _COUNTS.update(captures=0, capture_s=0.0, replays=0)


def _bump(key: str, n=1) -> None:
    with _counts_lock:
        _COUNTS[key] += n


@contextlib.contextmanager
def direct():
    """Inside, on this thread, every compiled call runs its function
    direct: another graph's function (:class:`Captured`), the analysis
    tools (``utils.profiling.memory_analysis``) and the checks that hold a
    graph against its direct call."""
    _direct.depth = getattr(_direct, "depth", 0) + 1
    try:
        yield
    finally:
        _direct.depth -= 1


def pool_bytes(device="cuda") -> Optional[dict]:
    """``{"reserved", "allocated"}``: the bytes of the segments of the
    compiled calls' memory pool on ``device`` (from
    ``torch.cuda.memory_snapshot``), or None before its first capture.
    The graphs' static inputs and outputs live outside the pool."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    got = _per_card.get(device)
    if got is None or got[2] is None:
        return None
    pool = tuple(got[2])
    reserved = allocated = 0
    for seg in torch.cuda.memory_snapshot():
        if (seg.get("device") == device.index
                and tuple(seg.get("segment_pool_id", ())) == pool):
            reserved += seg.get("total_size", 0)
            allocated += seg.get("allocated_size", 0)
    return {"reserved": reserved, "allocated": allocated}


def _graph_device(leaves: List[Any]) -> Optional[torch.device]:
    """The card a call's graph runs on, or None when the call runs direct
    by the module's rules (see the module's docstring)."""
    if (getattr(_direct, "depth", 0) or K.nan_checks_enabled()
            or K._cost_mode is not None
            or torch._C._len_torch_dispatch_stack() > 0):
        return None
    device = None
    grad = torch.is_grad_enabled()
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if ((grad and leaf.requires_grad) or torch._C._functorch
                    .is_functorch_wrapped_tensor(leaf)):
                return None
            if device is None and uses_graphs(leaf.device):
                device = leaf.device
        elif hasattr(leaf, "shards"):
            return None
    if (device is not None and device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        return None
    return device


_NARROW = (torch.bfloat16, torch.float16)


def _traces_floats(leaves: List[Any]) -> bool:
    """Whether a call's floats enter its graph as 0-d tensors: not beside
    a tensor narrower than float32.  A bf16 or f16 tensor's product with a
    0-d float32 tensor on the card rounds the rate to the narrow type,
    while the direct call multiplies by the Python number in float32; such
    a call keys its graph on the float's value instead (a new rate
    captures anew) and stays bit-equal to the direct call."""
    return not any(isinstance(t, torch.Tensor) and t.dtype in _NARROW
                   for t in leaves)


def _signature(args, traced: bool) -> Hashable:
    """The call's structure with each leaf's part of the key (leaves in
    :func:`flatten`'s order): a tensor by shape, dtype, device and
    contiguity, a float as traced (when ``traced``), anything else by
    value."""
    if isinstance(args, torch.Tensor):
        return (args.shape, args.dtype, args.device, args.is_contiguous())
    if isinstance(args, (tuple, list)):
        return (type(args),) + tuple(_signature(a, traced) for a in args)
    if args is None:
        return None
    if traced and isinstance(args, (float, np.floating)):
        return float
    try:
        hash(args)
    except TypeError:
        raise TypeError(
            f"a compiled call on the card takes tensors, numbers and "
            f"hashable values; got a {type(args).__name__}") from None
    return (type(args), args)


class _Statics:
    """The static buffers of a call's leaves: an empty contiguous tensor for
    each tensor (on its own device) but those read in place (``fixed``,
    the leaf itself, until :meth:`release`); for each float, when
    ``traced``, a 0-d tensor on ``device``, float64 beside a float64 tensor
    (its arithmetic is float64), else float32, whose product with a float32
    tensor takes the bits of the Python number's; the value itself for the
    rest."""

    def __init__(self, leaves: List[Any], device: torch.device,
                 traced: bool, fixed: Sequence[bool] = ()):
        rate = (torch.float64 if any(isinstance(t, torch.Tensor)
                                     and t.dtype == torch.float64
                                     for t in leaves) else torch.float32)
        self.bufs: List[Any] = []
        self.tensors, self.floats = [], []
        self.fixed = [i for i, f in enumerate(fixed) if f]
        for i, leaf in enumerate(leaves):
            if i in self.fixed:
                self.bufs.append(leaf)
            elif isinstance(leaf, torch.Tensor):
                self.tensors.append(i)
                self.bufs.append(torch.empty(leaf.shape, dtype=leaf.dtype,
                                             device=leaf.device))
            elif traced and isinstance(leaf, (float, np.floating)):
                self.floats.append(i)
                self.bufs.append(torch.empty((), dtype=rate, device=device))
            else:
                self.bufs.append(leaf)
        self.tensor_bufs = [self.bufs[i] for i in self.tensors]
        self.fill(leaves)

    def fill(self, leaves: List[Any]) -> None:
        """Copy a call's leaves in: the tensors in one ``_foreach_copy_``,
        each float by a fill."""
        if self.tensors:
            torch._foreach_copy_(self.tensor_bufs,
                                 [leaves[i] for i in self.tensors])
        for i in self.floats:
            self.bufs[i].fill_(float(leaves[i]))

    def release(self) -> None:
        """Drop the references to the leaves read in place, once the graph
        holds their addresses: the graph keeps no caller's tensor alive."""
        for i in self.fixed:
            self.bufs[i] = None

    def nbytes(self) -> int:
        """The bytes of the static tensor buffers."""
        return sum(b.numel() * b.element_size() for b in self.bufs
                   if isinstance(b, torch.Tensor))


def _tensor_leaves(res, what: str) -> List[torch.Tensor]:
    outs = flatten(res)
    for o in outs:
        if not isinstance(o, torch.Tensor):
            raise CaptureError(
                f"capturing {what} in a CUDA graph: it returns a "
                f"{type(o).__name__}; a captured function returns tensors "
                f"— {_REMEDY}")
    return outs


def _copies(bufs: List[torch.Tensor]) -> List[torch.Tensor]:
    """New tensors holding ``bufs``' values, for the caller to own."""
    outs = [torch.empty_like(b) for b in bufs]
    if outs:
        torch._foreach_copy_(outs, bufs)
    return outs


def _get(cache: ir.CompiledCache, key, make: Callable):
    """The graph of ``key`` in ``cache``, made by ``make()`` (under the
    process's capture lock) when it has none."""
    g = cache.get(key)
    if g is None:
        with _capture_lock:
            g = cache.get(key)
            if g is None:
                g = cache[key] = make()
    return g


def _captured(step: Callable, device: torch.device, what: str) -> Captured:
    """``step`` captured in the card's pool, counted."""
    t0 = time.perf_counter()
    captured = Captured(step, device, what, _REMEDY, pool=_card(device)[2])
    _bump("captures")
    _bump("capture_s", time.perf_counter() - t0)
    return captured


def _graph_key(args, traced: bool, where: tuple = ()) -> Hashable:
    """The call's signature, the plan epoch, the inference mode and
    ``where`` the tensors read in place lie (:meth:`Compiled._where`)."""
    return (_signature(args, traced), K.plan_epoch(),
            torch.is_inference_mode_enabled(), where)


# ---------------------------------------------------------------------------
# Compiled: one graph per signature
# ---------------------------------------------------------------------------

class _Graph:
    """One signature's graph of a :class:`Compiled`: the static buffers of
    its leaves and of its outputs (outside the shared pool), and the
    captured call, which copies its results into the output buffers."""

    def __init__(self, fn: Callable, args, leaves: List[Any],
                 device: torch.device, what: str, traced: bool,
                 fixed: Sequence[bool] = ()):
        self.statics = _Statics(leaves, device, traced, fixed)
        static_args = unflatten(args, self.statics.bufs)
        self.outs: List[torch.Tensor] = []
        self.first = self.template = None

        def step(commit: bool) -> None:
            res = fn(*static_args)
            outs = _tensor_leaves(res, what)
            if not commit:
                # the warm-up: the first call's results, and the buffers
                # the graph copies its outputs to
                self.template, self.first = res, outs
                self.outs = [torch.empty_like(o) for o in outs]
                return
            for b, o in zip(self.outs, outs):
                b.copy_(o)

        self.captured = _captured(step, device, what)
        self.statics.release()

    def nbytes(self) -> int:
        """The bytes of the graph's static inputs and outputs (outside the
        pool)."""
        return self.statics.nbytes() + sum(
            b.numel() * b.element_size() for b in self.outs)

    def first_call(self):
        """The warm-up's results, the first call's (the capture ran no
        kernel), as copies the caller owns."""
        outs, self.first = self.first, None
        return unflatten(self.template, _copies(outs))

    def run(self, leaves: List[Any]):
        with self.captured.lock:
            self.statics.fill(leaves)
            self.captured.replay()
            outs = _copies(self.outs)
        _bump("replays")
        return unflatten(self.template, outs)


class Compiled:
    """``fn`` with one CUDA graph per call signature on the card (see the
    module's docstring); ``fn`` itself is the direct call.

    The tensors of the arguments at the positions ``in_place`` (a model's
    weights) are no graph inputs: the graph reads them where they lie, as
    a request graph reads its model's weights, and keys on their addresses
    and strides.  They get no static copy and no copy per call, and the
    graph holds no reference to them; a call on tensors that lie elsewhere
    (another model's) captures a graph of its own."""

    def __init__(self, fn: Callable, what: str = "a compiled call",
                 in_place: Sequence[int] = ()):
        self.fn = fn
        self.what = what
        self.in_place = tuple(sorted(set(in_place)))
        self.graphs = ir.CompiledCache()

    def _fixed(self, args) -> List[bool]:
        """Per leaf of ``args``, whether the graph reads it in place."""
        return [i in self.in_place and isinstance(leaf, torch.Tensor)
                for i, a in enumerate(args) for leaf in flatten(a)]

    def _where(self, args) -> tuple:
        """The address and strides of each tensor read in place: a graph
        reads the memory it was captured on, so it replays only on the
        tensors found there now."""
        return tuple((t.data_ptr(), t.stride()) for i in self.in_place
                     for t in flatten(args[i]) if isinstance(t, torch.Tensor))

    def static_bytes(self) -> int:
        """The bytes of the static inputs and outputs of this callable's
        graphs."""
        return sum(g.nbytes() for g in list(self.graphs.values()))

    def __call__(self, *args):
        leaves = flatten(args)
        device = _graph_device(leaves)
        if device is None:
            return self.fn(*args)
        traced = _traces_floats(leaves)
        made = []

        def make():
            g = _Graph(self.fn, args, leaves, device, self.what, traced,
                       self._fixed(args))
            made.append(g)
            return g

        key = _graph_key(args, traced,
                         self._where(args) if self.in_place else ())
        g = _get(self.graphs, key, make)
        if made:
            return g.first_call()
        return g.run(leaves)


# ---------------------------------------------------------------------------
# Loop: one step replayed n times
# ---------------------------------------------------------------------------

def take(X: torch.Tensor, i) -> torch.Tensor:
    """Row ``i`` of ``X``: a Python index directly, a :class:`Loop`'s step
    counter (a 1-element tensor on the card) by ``index_select``."""
    if isinstance(i, torch.Tensor):
        return X.index_select(0, i)[0]
    return X[i]


class _LoopGraph:
    """One signature's step of a :class:`Loop`: static buffers of the carry
    (updated in place by each replay), of the constants and of the step
    counter; captured at its first run, whose first step is the warm-up."""

    def __init__(self, body: Callable, carry, consts, leaves: List[Any],
                 n_carry: int, device: torch.device, what: str,
                 traced: bool):
        self.body, self.what, self.device = body, what, device
        self.statics = _Statics(leaves, device, traced)
        self.carry_tmpl = carry
        self.carry_bufs = self.statics.bufs[:n_carry]
        self.carry = unflatten(carry, self.carry_bufs)
        self.consts = unflatten(consts, self.statics.bufs[n_carry:])
        self.ctr = torch.zeros(1, dtype=torch.int64, device=device)
        self.captured: Optional[Captured] = None
        self.lock = threading.Lock()

    def _step(self, commit: bool) -> None:
        # the warm-up is the loop's first step: it commits too
        new = _tensor_leaves(self.body(self.ctr, self.carry, *self.consts),
                             self.what)
        for b, v in zip(self.carry_bufs, new):
            if v is not b:
                b.copy_(v)
        self.ctr.add_(1)

    def run(self, n: int, leaves: List[Any]):
        with self.lock:
            self.statics.fill(leaves)
            self.ctr.zero_()
            todo = n
            if self.captured is None:
                self.captured = _captured(self._step, self.device, self.what)
                todo -= 1
            if todo:
                self.captured.replay(todo)
                _bump("replays", todo)
            out = _copies(self.carry_bufs)
        return unflatten(self.carry_tmpl, out)


class Loop:
    """``n`` steps ``carry = body(i, carry, *consts)``, the port's
    ``lax.scan`` / ``fori_loop``: on the card ONE step is captured in a
    CUDA graph per signature of ``(carry, consts)`` and replayed ``n``
    times (the first step is the capture's warm-up), the carry updated in
    place in the graph's static buffers and handed back as fresh tensors
    once, at the end; ``i`` is then a step counter on the card, which each
    replay advances (:func:`take` reads row ``i`` of a tensor).  Direct (by
    the module's rules), the same steps run in a Python loop with ``i`` an
    int.  ``n`` is no part of the signature."""

    def __init__(self, body: Callable, what: str = "a compiled loop"):
        self.body = body
        self.what = what
        self.graphs = ir.CompiledCache()

    def __call__(self, n: int, carry, *consts):
        n = int(n)
        n_carry = len(flatten(carry))
        leaves = flatten((carry, consts))
        device = _graph_device(leaves)
        if device is None or n == 0:
            for i in range(n):
                carry = self.body(i, carry, *consts)
            return carry
        traced = _traces_floats(leaves)
        g = _get(self.graphs, _graph_key((carry, consts), traced),
                 lambda: _LoopGraph(self.body, carry, consts, leaves,
                                    n_carry, device, self.what, traced))
        return g.run(n, leaves)
