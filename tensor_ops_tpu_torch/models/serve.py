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
"""

from __future__ import annotations

import bisect
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

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


class Predictor:
    """Batched prediction with shape bucketing: a request is padded to the
    next bucket, so a deployment serves a fixed set of batch shapes.

    Serves a staged-IR ``Network`` together with its backend ``be``, or a
    ``FusedMLP`` or ``QuantizedMLP`` (whose tensors carry their device)."""

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
        self._serving = (model, be, q_uniform, sharded)

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
        model, be, q_uniform, sharded = serving
        with torch.inference_mode():
            if isinstance(model, Network):
                return batched_run(model, be)(xb, *model.params)
            if isinstance(model, QuantizedMLP):
                return model.run_fused(xb) if q_uniform else model.run(xb)
            if sharded:
                return model.run_xla(xb)
            if not self.use_fused_kernel:
                return model.run(xb)
            if xb.shape[0] >= self.xla_threshold:
                return model.run_xla(xb)
            return model.run_fused_inference(xb)

    def warmup(self) -> None:
        """Run every bucket once ahead of serving (builds the kernels)."""
        serving = self._serving
        i = _in_width(serving[0])
        for b in self.buckets:
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
        self.timer.start()
        out = self._forward(serving, self._as(serving, x)).cpu().numpy()
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
        WARMED for every bucket BEFORE the switch, then swaps in with ONE
        atomic assignment (a concurrent request sees wholly-old or
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


class SequencePredictor:
    """Serving for the recurrent family: batched whole-sequence prediction
    with shape bucketing on the BATCH axis (a deployment serves a fixed set
    of batch shapes per sequence length).

    Stateless per request: every sequence starts from the network's stored
    initial states — the deployment analog of the reference's per-sequence
    ``runNetwork`` fold — and a batch runs as ONE scan
    (``RecurrentNetwork.run_seq``'s graph) mapped over the batch with
    ``torch.func.vmap``.  The forward of each length is cached in the op's
    ``CompiledCache`` under ``("serve_seq", n) + be.cache_key()``.
    Requests run under ``torch.inference_mode()``."""

    def __init__(self, rnet, be: Backend, buckets: Sequence[int] = (1, 8, 32)):
        # one tuple, swapped atomically by reload() — a request racing a
        # swap sees wholly-old or wholly-new (network, backend)
        self._serving = (rnet, be)
        self.buckets = sorted(buckets)
        self.timer = StepTimer()
        self._warmed: set = set()  # lengths warmup ran (for reload)

    @property
    def rnet(self):
        return self._serving[0]

    @property
    def be(self) -> Backend:
        return self._serving[1]

    def _forward_fn(self, n: int):
        from .recurrent import seq_scan_op

        rnet, be = self._serving  # capture locals, not self: the
        # op._compiled cache must not pin predictors (nor their timers)
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

    def warmup(self, lengths: Sequence[int]) -> None:
        """Run every (bucket, length) pair once ahead of serving (sequence
        length is part of the forward, so it must be supplied)."""
        rnet, be = self._serving
        in_shape = tuple(rnet.in_shape)
        for n in lengths:
            fn = self._forward_fn(int(n))
            for b in self.buckets:
                x = be.asarray(np.zeros((b, int(n)) + in_shape, np.float32))
                with torch.inference_mode():
                    fn(x, *rnet.states, *rnet.params).cpu()
            self._warmed.add(int(n))

    def predict(self, xs: Any) -> np.ndarray:
        """``(B, n, *in_shape)`` sequences -> ``(B, n, *out_shape)``
        outputs (a single ``(n, *in_shape)`` sequence is auto-batched)."""
        rnet, be = self._serving  # one consistent read per request
        xs = np.asarray(xs, dtype=np.float32)
        squeeze = xs.ndim == len(rnet.in_shape) + 1
        if squeeze:
            xs = xs[None]
        B = xs.shape[0]
        b = _bucket_of(self.buckets, B)
        if b != B:
            xs = np.pad(xs, ((0, b - B),) + ((0, 0),) * (xs.ndim - 1))
        fn = self._forward_fn(int(xs.shape[1]))
        self.timer.start()
        with torch.inference_mode():
            out = fn(be.asarray(xs), *rnet.states, *rnet.params).cpu()
        self.timer.stop()
        out = out.numpy()[:B]
        return out[0] if squeeze else out

    def latency(self) -> dict:
        return self.timer.summary()

    def reload(self, rnet, be: Optional[Backend] = None,
               warm_lengths: Optional[Sequence[int]] = None) -> None:
        """Zero-downtime recurrent model swap (``Predictor.reload``'s
        semantics): the replacement is warmed for every previously-warmed
        sequence length plus any extra ``warm_lengths``, for every bucket,
        BEFORE the (rnet, be) pair swaps in one atomic assignment.  The
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
        self._warmed = set(lengths)
        self._serving = (rnet, be)  # the one atomic switch
