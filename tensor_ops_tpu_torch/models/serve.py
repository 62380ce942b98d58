"""Serving: a warm, latency-tracked predictor over trained networks.

The reference has no inference story beyond calling ``runNetwork`` in a
loop; for production serving this wraps a staged-IR ``Network`` (with its
backend), a ``FusedMLP`` or an int8 ``QuantizedMLP`` with shape-bucketed
forwards, explicit warmup, latency statistics and an atomic hot swap.

Routing is the JAX package's: a ``Network`` runs its graph vmapped over the
batch (``batched_run``); for a ``FusedMLP``, batches under
``xla_threshold`` go to the whole-network kernel ``fused_mlp_forward``,
larger ones to plain matmuls (``FusedMLP.run_xla``), and
``use_fused_kernel=False`` sends every batch through the per-layer kernel
``fused_linear``.  A ``FusedMLP`` with a weight sharded over a mesh axis of
more than one rank (``parallel.mesh.shard_fused`` on a model axis > 1)
serves every bucket through ``run_xla``, tensor-parallel on its mesh: the
kernels take whole weights.  One placed on a mesh with nothing sharded (a
``(dp, 1)`` mesh, or weights ``param_specs`` replicated) serves as a whole
model from rank 0's copy, as the JAX package serves it.  A
``QuantizedMLP`` whose stack is uniform (every layer N x N, N % 128 == 0)
and has one hidden activation runs the whole-MLP kernel
``fused_mlp_w8a8_forward`` (``run_fused``); any other, or any with
``use_fused_kernel=False``, runs its per-layer int8 kernel (``run``).  No
``xla_threshold`` applies to int8.

``SequencePredictor`` serves the recurrent family: whole sequences through
the ``RecurrentNetwork``'s scan, ``torch.func.vmap``-ed over a batch padded
to a bucket.

On the card a request is one CUDA graph launch, the port's form of the JAX
package's program compiled once per shape: each bucket's forward (each
(bucket, length) pair's for a ``SequencePredictor``) is captured once, by
``warmup()``, before ``reload()`` switches, or at its first request, and
replayed from then on (:class:`RequestGraph`).  The graphs belong to the
serving state, which ``reload()`` swaps in one assignment; the shapes
beyond the buckets (the lengths ``warmup`` did not name) are kept in an
LRU with the bound of the op's ``CompiledCache``, as the JAX package keeps
its compiled forwards.  A capture that fails raises
``engine.CaptureError`` naming the operation: a request on the card never
runs by direct launches.  The mesh-sharded route
(``tp.fused_forward``, whose kernel-9 calls across the group's ranks are
ordered by a host lock) and a model on the CPU run direct.
"""

from __future__ import annotations

import bisect
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Union

import numpy as np
import torch

from .. import engine
from ..backend.base import Backend
from ..ops import ir
from ..utils.profiling import StepTimer
from .fast import FusedMLP, QuantizedMLP
from .feedforward import Network
from .training import batched_run

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _is_model_sharded(w) -> bool:
    """True when a weight is genuinely sharded (the JAX package's rule: on
    more than one device and not fully replicated): a
    ``parallel.mesh.Sharded`` leaf whose spec splits it over an axis of
    more than one rank."""
    if not (hasattr(w, "shards") and hasattr(w, "spec")):
        return False
    return any(a is not None and w.mesh.shape.get(a, 1) > 1 for a in w.spec)


def _rank0_copy(model: FusedMLP) -> FusedMLP:
    """A mesh-placed ``FusedMLP`` none of whose weights is sharded: its
    whole copy on rank 0, which the kernels serve."""
    return FusedMLP(tuple(w.local for w in model.weights),
                    tuple(b.local for b in model.biases), model.acts,
                    model.softmax_out, model.precision, model.loss_kind)


def _bucket_of(buckets, n: int) -> int:
    """Pad target for a batch of n rows: the next bucket, or beyond the
    largest bucket the next multiple of it (so the set of batch shapes a
    predictor serves stays bounded)."""
    i = bisect.bisect_left(buckets, n)
    if i < len(buckets):
        return buckets[i]
    top = buckets[-1]
    return ((n + top - 1) // top) * top


_REMEDY = ("a request on the card is never served by direct launches; a "
           "model on the CPU runs direct")
# one capture of a shape at a time (the capture itself takes the engine's
# lock: the card's capture stream is shared)
_capture_lock = threading.Lock()
_counts_lock = threading.Lock()
_COUNTS = {"captures": 0, "replays": 0}


def graph_counts() -> dict:
    """``{"captures", "replays"}`` of this process's request graphs."""
    with _counts_lock:
        return dict(_COUNTS)


def reset_graph_counts() -> None:
    with _counts_lock:
        _COUNTS.update(captures=0, replays=0)


def _bump(key: str) -> None:
    with _counts_lock:
        _COUNTS[key] += 1


class RequestGraph(engine.Captured):
    """One request shape's forward captured in a CUDA graph over the static
    input ``x``: the output ``out`` it rewrites on every replay, the kernel
    launches it holds (counted on every replay, as a direct forward counts
    them) and the scratch its kernels write, which is its own
    (:class:`engine.Captured`).

    :meth:`run` holds the graph's lock from the input's copy to the
    output's copy to the host, so concurrent requests on one shape take
    turns on its buffers."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor, what: str):
        self.x = x
        self.out: Optional[torch.Tensor] = None

        def fn(commit: bool) -> None:
            with torch.inference_mode():
                out = forward(x)
            if commit:
                self.out = out

        # warmed up on the card's replay stream, captured on its capture
        # stream (Captured's; no garbage collection, which would stall
        # every request thread), in a memory pool of its own
        super().__init__(fn, x.device, what, _REMEDY)

    def run(self, x: np.ndarray) -> np.ndarray:
        src = torch.from_numpy(x)
        with self.lock:
            self.x.copy_(src)
            self.replay()
            out = self.out.cpu()
        _bump("replays")
        return out.numpy()


class _Graphs:
    """The request graphs of one serving state, by shape key.  The kept
    ones (``keep``: the buckets ``warmup`` readies) stay; the others live
    in an LRU of ``maxsize`` groups, a group being ``group(key)``: the
    shape itself for a ``Predictor``, the sequence length for a
    ``SequencePredictor`` (whose graphs of one length go together, as the
    JAX package keeps one jitted forward per length for every bucket).
    ``forward(key, x)`` is the direct forward, ``make_input(key)`` the
    static input, ``what(key)`` names the capture in an error."""

    maxsize = ir.CompiledCache.DEFAULT_MAXSIZE

    def __init__(self, forward: Callable, make_input: Callable,
                 what: Callable, group: Callable = lambda key: key):
        self._forward, self._make_input, self._what = (forward, make_input,
                                                       what)
        self._group = group
        self._fixed: Dict[Hashable, RequestGraph] = {}
        self._lru: "OrderedDict[Hashable, Dict[Hashable, RequestGraph]]" = (
            OrderedDict())
        self._lock = threading.Lock()

    def _find(self, key) -> Optional[RequestGraph]:
        with self._lock:
            g = self._fixed.get(key)
            if g is None:
                graphs = self._lru.get(self._group(key))
                if graphs is not None:
                    self._lru.move_to_end(self._group(key))
                    g = graphs.get(key)
            return g

    def get(self, key, keep: bool) -> RequestGraph:
        """The graph of ``key``, captured now if there is none; ``keep``
        puts a new one among the kept graphs, else in its LRU group."""
        g = self._find(key)
        if g is not None:
            return g
        with _capture_lock:
            g = self._find(key)
            if g is not None:
                return g
            forward = self._forward
            g = RequestGraph(lambda x: forward(key, x),
                             self._make_input(key), self._what(key))
            _bump("captures")
            with self._lock:
                if keep:
                    self._fixed[key] = g
                else:
                    grp = self._group(key)
                    self._lru.setdefault(grp, {})[key] = g
                    self._lru.move_to_end(grp)
                    while len(self._lru) > self.maxsize:
                        self._lru.popitem(last=False)
        return g

    def keys(self) -> tuple:
        """The kept keys, then the LRU's, its groups from oldest to
        newest."""
        with self._lock:
            return tuple(self._fixed) + self._lru_keys()

    def _lru_keys(self) -> tuple:
        return tuple(k for graphs in self._lru.values() for k in graphs)

    def capture_like(self, other: Optional["_Graphs"]) -> None:
        """Capture the shapes of ``other``'s LRU, oldest group first (a
        reload: the replacement serves every shape the current state has
        served without a capture inside a request)."""
        if other is None:
            return
        with other._lock:
            keys = other._lru_keys()
        for key in keys:
            self.get(key, keep=False)


def _graphs_on(device) -> bool:
    """Whether a model on ``device`` (None: a backend without one, the
    NumPy oracle) serves from request graphs."""
    return device is not None and engine.uses_graphs(device)


def _servable(model, be: Optional[Backend], dtype: Optional[str]):
    if isinstance(model, Network):
        if be is None:
            raise ValueError("Network predictor needs a backend")
        if dtype is not None:
            raise ValueError("dtype= applies to FusedMLP models (Network "
                             "predictors follow their backend)")
        return model
    if isinstance(model, QuantizedMLP):
        if dtype is not None:
            raise ValueError("dtype= applies to FusedMLP models (a "
                             "QuantizedMLP is int8 already)")
        return model
    if not isinstance(model, FusedMLP):
        raise TypeError(f"Predictor serves a Network, a FusedMLP or a "
                        f"QuantizedMLP, got {type(model).__name__}")
    if dtype is not None:
        # storage-dtype knob: "bf16" halves the weight memory
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        model = model.astype(_DTYPES[dtype])
    return model


def _direct(route, xb: torch.Tensor, use_fused_kernel: bool,
            xla_threshold: int) -> torch.Tensor:
    """A ``Predictor`` route's forward of ``xb``, launched from the host."""
    model, be, q_uniform, sharded = route[:4]
    with torch.inference_mode():
        if isinstance(model, Network):
            return batched_run(model, be)(xb, *model.params)
        if isinstance(model, QuantizedMLP):
            return model.run_fused(xb) if q_uniform else model.run(xb)
        if sharded:
            return model.run_xla(xb)
        if not use_fused_kernel:
            return model.run(xb)
        if xb.shape[0] >= xla_threshold:
            return model.run_xla(xb)
        return model.run_fused_inference(xb)


class Predictor:
    """Batched prediction with shape bucketing: a request is padded to the
    next bucket, so a deployment serves a fixed set of batch shapes.

    Serves a staged-IR ``Network`` together with its backend ``be``, or a
    ``FusedMLP`` or ``QuantizedMLP`` (whose tensors carry their device).
    On the card each bucket is served from its request graph, captured by
    :meth:`warmup` or at the bucket's first request."""

    def __init__(
        self,
        model: Union[Network, FusedMLP, QuantizedMLP],
        be: Optional[Backend] = None,
        buckets: Sequence[int] = (1, 8, 32, 128, 512),
        use_fused_kernel: bool = True,
        xla_threshold: int = 64,
        dtype: Optional[str] = None,
    ):
        self.buckets = sorted(buckets)
        self.use_fused_kernel = use_fused_kernel
        self.xla_threshold = xla_threshold
        self._dtype = dtype  # remembered so reload() keeps the knob
        self.timer = StepTimer()
        # ONE attribute holds what a request routes on (the backend
        # included: a Network swapped in by reload() arrives with its
        # backend), so a reload() swap is a single atomic assignment
        model = _servable(model, be, dtype)
        q_uniform = (isinstance(model, QuantizedMLP) and use_fused_kernel
                     and model.uniform() and len(set(model.acts[:-1])) <= 1)
        # a mesh-sharded FusedMLP (parallel.mesh.shard_fused) serves on its
        # mesh at every bucket, below xla_threshold too: the fused kernels
        # cannot take its weights; placed but with nothing sharded, it
        # serves whole from rank 0's copy
        sharded = isinstance(model, FusedMLP) and any(
            _is_model_sharded(w) for w in model.weights)
        if isinstance(model, FusedMLP) and model.sharded and not sharded:
            model = _rank0_copy(model)
        route = (model, be, q_uniform, sharded)
        self._serving = route + (self._graphs_for(route),)

    def _graphs_for(self, route) -> Optional[_Graphs]:
        """The request graphs of a serving route on the card (none on the
        CPU, or for the mesh-sharded route, which runs direct)."""
        model, be, _, sharded = route
        device = (getattr(be, "device", None) if isinstance(model, Network)
                  else model.device)
        if sharded or not _graphs_on(device):
            return None
        fused, threshold = self.use_fused_kernel, self.xla_threshold
        width, kind = _in_width(model), type(model).__name__
        return _Graphs(
            lambda b, x: _direct(route, x, fused, threshold),
            lambda b: Predictor._as(route, np.zeros((b, width), np.float32)),
            lambda b: f"the {kind} request forward at batch {b}")

    @property
    def model(self) -> Union[Network, FusedMLP, QuantizedMLP]:
        return self._serving[0]

    @property
    def be(self) -> Optional[Backend]:
        return self._serving[1]

    @property
    def _sharded(self) -> bool:
        return self._serving[3]

    def _bucket(self, n: int) -> int:
        return _bucket_of(self.buckets, n)

    def _forward(self, serving, xb: torch.Tensor) -> torch.Tensor:
        """The direct forward: every kernel launched from the host (the
        engine's compiled ``batched_run`` of a ``Network`` included)."""
        with engine.direct():
            return _direct(serving, xb, self.use_fused_kernel,
                           self.xla_threshold)

    def warmup(self) -> None:
        """Ready every bucket ahead of serving: on the card capture its
        request graph, elsewhere run it once (builds the kernels)."""
        serving = self._serving
        graphs = serving[4]
        i = _in_width(serving[0])
        for b in self.buckets:
            if graphs is not None:
                graphs.get(b, keep=True)
                continue
            x = np.zeros((b, i), dtype=np.float32)
            self._forward(serving, self._as(serving, x)).cpu()

    @staticmethod
    def _as(serving, x: np.ndarray) -> torch.Tensor:
        model, be = serving[:2]
        if isinstance(model, Network):
            return be.asarray(x)
        return torch.as_tensor(x, dtype=torch.float32, device=model.device)

    def predict(self, x: Any) -> np.ndarray:
        """Class probabilities for a batch (any leading size)."""
        serving = self._serving  # one consistent read per request
        x = np.asarray(x, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        n = x.shape[0]
        b = self._bucket(n)
        if b != n:
            x = np.pad(x, ((0, b - n), (0, 0)))
        graphs = serving[4]
        self.timer.start()
        if graphs is None:
            out = self._forward(serving, self._as(serving, x)).cpu().numpy()
        else:
            out = graphs.get(b, keep=b in self.buckets).run(x)
        self.timer.stop()
        out = out[:n]
        return out[0] if squeeze else out

    def predict_class(self, x: Any) -> np.ndarray:
        p = self.predict(x)
        return np.argmax(p, axis=-1)

    def latency(self) -> dict:
        return self.timer.summary()

    _KEEP = object()  # reload sentinel: inherit this predictor's knob

    def reload(self, model, dtype=_KEEP, be: Optional[Backend] = None
               ) -> None:
        """Zero-downtime model swap: the replacement is converted and
        WARMED for every bucket BEFORE the switch (on the card: every
        bucket's request graph captured, and those of the shapes beyond
        the buckets that the current state holds; a capture that fails
        raises and the current model goes on serving), then swaps in,
        graphs included,
        with ONE atomic assignment (a concurrent request sees wholly-old or
        wholly-new).  The replacement must serve the same input and
        output widths; its kind may change (pass ``be=`` for a Network
        when this predictor has none).  ``dtype`` defaults to the knob
        this predictor was built with; pass None or another value to
        change it.  An inherited knob is not applied to a Network (its
        backend sets its dtype) or a QuantizedMLP (int8 already) but is
        remembered for a later FusedMLP.  Latency stats continue across
        the swap."""
        explicit = dtype is not Predictor._KEEP
        remembered = dtype if explicit else self._dtype
        if not explicit:
            dtype = self._dtype if isinstance(model, FusedMLP) else None
        new = Predictor(model, be=be or self.be, buckets=self.buckets,
                        use_fused_kernel=self.use_fused_kernel,
                        xla_threshold=self.xla_threshold, dtype=dtype)
        for what, old_w, new_w in (
                ("input", _in_width(self.model), _in_width(new.model)),
                ("output", _out_width(self.model), _out_width(new.model))):
            if old_w != new_w:
                raise ValueError(
                    f"reload would change the serving interface: "
                    f"current model's {what} width is {old_w}, the "
                    f"replacement's is {new_w} — deploy a new Predictor "
                    f"instead")
        new.warmup()  # build and run every bucket before anyone sees it
        if new._serving[4] is not None:  # and the shapes served beyond them
            new._serving[4].capture_like(self._serving[4])
        self._dtype = remembered
        self._serving = new._serving  # the one atomic switch


def _in_width(model) -> int:
    if isinstance(model, QuantizedMLP):
        return model.wqs[0].shape[1]
    if isinstance(model, FusedMLP):
        return model.weights[0].shape[1]
    return model.in_shape[0]


def _out_width(model) -> int:
    if isinstance(model, QuantizedMLP):
        return model.wqs[-1].shape[0]
    if isinstance(model, FusedMLP):
        return model.weights[-1].shape[0]
    return model.out_shape[0]


def _seq_fn(rnet, be: Backend, n: int):
    """The batched forward of sequences of length ``n``: the scan of
    ``RecurrentNetwork.run_seq``'s graph, vmapped over the batch, cached in
    the op's ``CompiledCache`` under ``("serve_seq", n) + be.cache_key()``
    (a function of the op alone: it holds no parameters and no graph)."""
    from .recurrent import seq_scan_op

    k = len(rnet.states)
    key = ("serve_seq", n) + be.cache_key()
    fn = rnet.op._compiled.get(key)
    if fn is None:
        scan = seq_scan_op(rnet.op, n, k)

        def one(xs, *sp):
            return ir.run(scan, be, (xs,) + sp)[0]

        nsp = k + len(rnet.params)
        fn = torch.func.vmap(one, in_dims=(0,) + (None,) * nsp)
        rnet.op._compiled[key] = fn
    return fn


def _seq_run(rnet, be: Backend, x: torch.Tensor) -> torch.Tensor:
    """``(B, n, *in_shape)`` sequences through :func:`_seq_fn`."""
    with torch.inference_mode():
        return _seq_fn(rnet, be, int(x.shape[1]))(x, *rnet.states,
                                                   *rnet.params)


class SequencePredictor:
    """Serving for the recurrent family: batched whole-sequence prediction
    with shape bucketing on the BATCH axis (a deployment serves a fixed set
    of batch shapes per sequence length).

    Stateless per request: every sequence starts from the network's stored
    initial states — the deployment analog of the reference's per-sequence
    ``runNetwork`` fold — and a batch runs as ONE scan
    (``RecurrentNetwork.run_seq``'s graph) mapped over the batch with
    ``torch.func.vmap`` (:func:`_seq_fn`).  On the card each (bucket,
    length) pair is served from its request graph, captured by
    :meth:`warmup` for the lengths it names or at the pair's first request
    (those of the op's ``CompiledCache`` bound of lengths kept in an LRU,
    each length with the graphs of every batch it served); the graphs are
    part of the serving state, not of the op's cache.  Requests run under
    ``torch.inference_mode()``."""

    def __init__(self, rnet, be: Backend, buckets: Sequence[int] = (1, 8, 32)):
        # one tuple, swapped atomically by reload() — a request racing a
        # swap sees wholly-old or wholly-new (network, backend, graphs)
        self._serving = (rnet, be, self._graphs_for(rnet, be))
        self.buckets = sorted(buckets)
        self.timer = StepTimer()
        self._warmed: set = set()  # lengths warmup ran (for reload)

    @staticmethod
    def _graphs_for(rnet, be: Backend) -> Optional[_Graphs]:
        if not _graphs_on(getattr(be, "device", None)):
            return None
        in_shape = tuple(rnet.in_shape)
        return _Graphs(
            lambda key, x: _seq_run(rnet, be, x),
            lambda key: be.asarray(np.zeros(key + in_shape, np.float32)),
            lambda key: (f"the SequencePredictor request forward at batch "
                         f"{key[0]}, length {key[1]}"),
            group=lambda key: key[1])

    @property
    def rnet(self):
        return self._serving[0]

    @property
    def be(self) -> Backend:
        return self._serving[1]

    def warmup(self, lengths: Sequence[int]) -> None:
        """Ready every (bucket, length) pair ahead of serving (sequence
        length is part of the forward, so it must be supplied): on the card
        capture its request graph, elsewhere run it once."""
        rnet, be, graphs = self._serving
        in_shape = tuple(rnet.in_shape)
        for n in lengths:
            for b in self.buckets:
                if graphs is not None:
                    graphs.get((b, int(n)), keep=True)
                    continue
                x = be.asarray(np.zeros((b, int(n)) + in_shape, np.float32))
                _seq_run(rnet, be, x).cpu()
            self._warmed.add(int(n))

    def predict(self, xs: Any) -> np.ndarray:
        """``(B, n, *in_shape)`` sequences -> ``(B, n, *out_shape)``
        outputs (a single ``(n, *in_shape)`` sequence is auto-batched)."""
        rnet, be, graphs = self._serving  # one consistent read per request
        xs = np.asarray(xs, dtype=np.float32)
        squeeze = xs.ndim == len(rnet.in_shape) + 1
        if squeeze:
            xs = xs[None]
        B = xs.shape[0]
        b = _bucket_of(self.buckets, B)
        if b != B:
            xs = np.pad(xs, ((0, b - B),) + ((0, 0),) * (xs.ndim - 1))
        n = int(xs.shape[1])
        fn = _seq_fn(rnet, be, n) if graphs is None else None
        self.timer.start()
        if fn is not None:
            with torch.inference_mode():
                out = fn(be.asarray(xs), *rnet.states, *rnet.params).cpu()
            out = out.numpy()
        else:
            out = graphs.get((b, n), keep=False).run(xs)
        self.timer.stop()
        out = out[:B]
        return out[0] if squeeze else out

    def latency(self) -> dict:
        return self.timer.summary()

    def reload(self, rnet, be: Optional[Backend] = None,
               warm_lengths: Optional[Sequence[int]] = None) -> None:
        """Zero-downtime recurrent model swap (``Predictor.reload``'s
        semantics): the replacement is warmed (on the card: its graphs
        captured) for every previously-warmed sequence length plus any
        extra ``warm_lengths``, for every bucket (on the card also the
        shapes of the other lengths the current state holds), BEFORE its
        serving state
        (network, backend and graphs) swaps in one atomic assignment.  The
        replacement must serve the same interface (in/out shapes)."""
        be = be or self.be
        for what, old_s, new_s in (
                ("input", tuple(self.rnet.in_shape), tuple(rnet.in_shape)),
                ("output", tuple(self.rnet.out_shape),
                 tuple(rnet.out_shape))):
            if old_s != new_s:
                raise ValueError(
                    f"reload would change the serving interface: "
                    f"current model's {what} shape is {old_s}, the "
                    f"replacement's is {new_s} — deploy a new "
                    f"SequencePredictor instead")
        # warm the UNION of previously-warmed lengths and any extras the
        # caller names — every length that was warm stays warm across the
        # swap, so _warmed never overstates what has been run
        lengths = sorted(self._warmed
                         | set(int(n) for n in (warm_lengths or ())))
        staging = SequencePredictor(rnet, be, buckets=self.buckets)
        staging.warmup(lengths)  # run before anyone sees it
        if staging._serving[2] is not None:  # and the other lengths served
            staging._serving[2].capture_like(self._serving[2])
        self._warmed = set(lengths)
        self._serving = staging._serving  # the one atomic switch
