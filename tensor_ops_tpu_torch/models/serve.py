"""Serving: a warm, latency-tracked predictor over trained networks.

The reference has no inference story beyond calling ``runNetwork`` in a
loop; for production serving this wraps a ``FusedMLP`` with shape-bucketed
forwards, explicit warmup, latency statistics and an atomic hot swap.

Routing is the JAX package's: batches under ``xla_threshold`` go to the
whole-network kernel ``fused_mlp_forward``, larger ones to plain matmuls
(``FusedMLP.run_xla``), and ``use_fused_kernel=False`` sends every batch
through the per-layer kernel ``fused_linear``.

Not yet ported: a staged-IR ``Network`` served directly (it needs
``models/training.py``'s ``batched_run``), the mesh-sharded route,
``QuantizedMLP`` and ``SequencePredictor`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import bisect
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import StepTimer
from .fast import FusedMLP
from .feedforward import Network

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _bucket_of(buckets, n: int) -> int:
    """Pad target for a batch of n rows: the next bucket, or beyond the
    largest bucket the next multiple of it (so the set of batch shapes a
    predictor serves stays bounded)."""
    i = bisect.bisect_left(buckets, n)
    if i < len(buckets):
        return buckets[i]
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def _servable(model, dtype: Optional[str]) -> FusedMLP:
    if isinstance(model, Network):
        raise TypeError(
            "serving a staged-IR Network directly needs "
            "models/training.py's batched_run, which is not ported yet "
            "(ROADMAP.md Queue 1: 'Flagship learn layer'); convert it "
            "with FusedMLP.from_network")
    if not isinstance(model, FusedMLP):
        raise TypeError(f"Predictor serves a FusedMLP, got "
                        f"{type(model).__name__}")
    if dtype is not None:
        # storage-dtype knob: "bf16" halves the weight memory
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        model = model.astype(_DTYPES[dtype])
    return model


class Predictor:
    """Batched prediction with shape bucketing: a request is padded to the
    next bucket, so a deployment serves a fixed set of batch shapes."""

    def __init__(
        self,
        model: FusedMLP,
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
        # ONE attribute holds what a request routes on, so a reload() swap
        # is a single atomic assignment
        self._model = _servable(model, dtype)

    @property
    def model(self) -> FusedMLP:
        return self._model

    def _bucket(self, n: int) -> int:
        return _bucket_of(self.buckets, n)

    def _forward(self, model: FusedMLP, xb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if not self.use_fused_kernel:
                return model.run(xb)
            if xb.shape[0] >= self.xla_threshold:
                return model.run_xla(xb)
            return model.run_fused_inference(xb)

    def warmup(self) -> None:
        """Run every bucket once ahead of serving (builds the kernels)."""
        model = self._model
        i = model.weights[0].shape[1]
        for b in self.buckets:
            x = np.zeros((b, i), dtype=np.float32)
            self._forward(model, self._as(model, x)).cpu()

    @staticmethod
    def _as(model: FusedMLP, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=model.device)

    def predict(self, x: Any) -> np.ndarray:
        """Class probabilities for a batch (any leading size)."""
        model = self._model  # one consistent read per request
        x = np.asarray(x, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        n = x.shape[0]
        b = self._bucket(n)
        if b != n:
            x = np.pad(x, ((0, b - n), (0, 0)))
        self.timer.start()
        out = self._forward(model, self._as(model, x)).cpu().numpy()
        self.timer.stop()
        out = out[:n]
        return out[0] if squeeze else out

    def predict_class(self, x: Any) -> np.ndarray:
        p = self.predict(x)
        return np.argmax(p, axis=-1)

    def latency(self) -> dict:
        return self.timer.summary()

    _KEEP = object()  # reload sentinel: inherit this predictor's knob

    def reload(self, model: FusedMLP, dtype=_KEEP) -> None:
        """Zero-downtime model swap: the replacement is converted and
        WARMED for every bucket BEFORE the switch, then swaps in with ONE
        atomic assignment (a concurrent request sees wholly-old or
        wholly-new).  The replacement must serve the same input and
        output widths.  ``dtype`` defaults to the knob this predictor was
        built with; pass None or another value to change it.  Latency
        stats continue across the swap."""
        if dtype is Predictor._KEEP:
            dtype = self._dtype
        new = Predictor(model, buckets=self.buckets,
                        use_fused_kernel=self.use_fused_kernel,
                        xla_threshold=self.xla_threshold, dtype=dtype)
        old_m, new_m = self._model, new.model
        for what, old_w, new_w in (
                ("input", old_m.weights[0].shape[1], new_m.weights[0].shape[1]),
                ("output", old_m.weights[-1].shape[0],
                 new_m.weights[-1].shape[0])):
            if old_w != new_w:
                raise ValueError(
                    f"reload would change the serving interface: "
                    f"current model's {what} width is {old_w}, the "
                    f"replacement's is {new_w} — deploy a new Predictor "
                    f"instead")
        new.warmup()  # build and run every bucket before anyone sees it
        self._dtype = dtype
        self._model = new.model  # the one atomic switch
