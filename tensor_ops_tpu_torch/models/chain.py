"""Step chaining: a window of training steps over a dataset resident on the
device, the port's form of the JAX package's chained ``lax.scan``
(``trainer._ChainedStep``, the chained step of ``fit`` and
``fit_sequences``).

:class:`StepChain` runs ``k`` steps of one step function ``body``.  Step
``i`` of a window gathers its batch from the resident dataset by row
``i`` of an index table and reads its step-varying scalars (the learning
rate, or the two rates of ``fit_sequences``) from row ``i`` of a scalar
table; everything else that changes from step to step (adam's step count,
``adam8bit``'s rounding noise) is computed on the device from the state.

On the card the step is captured ONCE in a CUDA graph and the graph is
replayed ``k`` times a window: the state (parameters, optimizer state,
EMA) lives in the graph's static buffers, which each replay overwrites,
and a step counter on the device, advanced by the graph itself, selects
the rows of the two tables, so one graph serves every window length.  The
host issues one graph launch per step instead of the step's hundreds or
thousands of kernel launches.  A capture that fails raises
:class:`CaptureError` naming the operation that broke it: a chained
window on the card never runs eagerly behind the caller's back.  Only a
batch of another size (the ragged last batch of a ``fit`` epoch) runs the
same step eagerly, as the JAX package runs it unchained.

Elsewhere (the CPU) the window is the same step run eagerly ``k`` times on
the same tables.  :func:`chain_counts` holds the captures, their host
time and the replays of this process.

:func:`engine.capture` captures the step; the engine's ``CaptureError``
is this module's too.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import engine
from ..engine import CaptureError

_COUNTS = {"captures": 0, "capture_s": 0.0, "replays": 0}


def chain_counts() -> dict:
    """``{"captures", "capture_s", "replays"}`` of this process's chained
    windows: graphs captured, the host seconds their warm-up and capture
    took, and graph launches (the request graphs and the engine's keep
    counts of their own)."""
    return dict(_COUNTS)


def reset_chain_counts() -> None:
    _COUNTS.update(captures=0, capture_s=0.0, replays=0)


class StepChain:
    """Windows of ``body`` over the resident dataset ``(Xd, Yd)``.

    ``body(scalars, xb, yb, leaves) -> (loss, new_leaves)`` is one training
    step on the flat state ``leaves`` (``engine.flatten`` order), ``scalars``
    a tuple of ``n_scalars`` 0-d tensors in ``dtype``.  :meth:`run` takes a
    window's scalar table (``(k, n_scalars)`` float64, host) and row table
    (``(k, rows)`` int64, host or device) and returns the last step's loss
    and the state after the window.  On the card the returned state IS the
    graph's static buffers: the next window updates them in place, and
    leaves that are not those buffers (a first window, a resume, an eager
    ragged step) are copied in first, a host number as a 0-d tensor.  Not
    cached across ``fit`` calls: each holds its own graph, buffers and
    memory pool."""

    def __init__(self, body: Callable, Xd: torch.Tensor, Yd: torch.Tensor,
                 n_scalars: int, batch: int, dtype: torch.dtype):
        self.body = body
        self.Xd, self.Yd = Xd, Yd
        self.device = Xd.device
        self.n_scalars, self.batch, self.dtype = n_scalars, batch, dtype
        self.graph = None
        self.cap = self.cap_captured = 0
        self.bufs: Optional[List[torch.Tensor]] = None
        self.busy = False  # a window's replays are in flight

    def reserve(self, cap: int) -> None:
        """Size the tables for windows of up to ``cap`` steps before the
        first capture (a longer window recaptures)."""
        self.cap = max(self.cap, int(cap))

    def close(self) -> None:
        """Release the graph and its memory pool now (the state buffers
        stay: they are the run's result)."""
        self.graph = self.scal = self.idx = None
        self.body = None

    def run(self, scalars: np.ndarray, rows, leaves: Sequence[Any]):
        k = scalars.shape[0]
        rows = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        if not engine.uses_graphs(self.device) or rows.shape[1] != self.batch:
            return self._eager(scalars, rows, list(leaves))
        self.busy = True
        leaves = [self._on_device(x) for x in leaves]
        if self.graph is None or k > self.cap_captured:
            self._capture(max(k, self.cap), leaves)
        for b, leaf in zip(self.bufs, leaves):
            if leaf is not b:
                b.copy_(leaf)
        self.scal[:k].copy_(torch.from_numpy(np.ascontiguousarray(scalars)))
        self.idx[:k].copy_(rows)
        self.ctr.zero_()
        for _ in range(k):
            self.graph.replay()
        _COUNTS["replays"] += k
        self.busy = False
        return self.loss, list(self.bufs)

    def _eager(self, scalars, rows, leaves):
        sc = torch.from_numpy(np.ascontiguousarray(scalars)).to(
            device=self.device, dtype=self.dtype)
        v = None
        for i in range(scalars.shape[0]):
            xb = self.Xd.index_select(0, rows[i])
            yb = self.Yd.index_select(0, rows[i])
            v, leaves = self.body(tuple(sc[i, j] for j in range(
                self.n_scalars)), xb, yb, tuple(leaves))
            leaves = list(leaves)
        return v, leaves

    def _on_device(self, x):
        """A state leaf as a tensor on the card: a host number (a custom
        optimizer's step count) becomes a 0-d tensor, as ``lax.scan``
        carries it, so the graph advances it instead of freezing it."""
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (bool, int, float, np.generic, np.ndarray)):
            a = np.asarray(x)
            t = torch.as_tensor(a, device=self.device)
            return t.to(self.dtype) if a.dtype.kind == "f" else t
        raise CaptureError(
            f"a chained step on the card carries its state in tensors; "
            f"this state holds a {type(x).__name__} leaf — pass "
            f"chain_steps=1")

    def _capture(self, cap: int, leaves: Sequence[Any]) -> None:
        dev = self.device
        if self.bufs is None:
            # the warm-up step reads them: the state's values, not garbage
            self.bufs = [x.clone() for x in leaves]
            self.ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        self.scal = torch.zeros((cap, self.n_scalars), dtype=self.dtype,
                                device=dev)
        self.idx = torch.zeros((cap, self.batch), dtype=torch.int64,
                               device=dev)
        self.loss = None
        self.graph = None

        def step(commit: bool):
            i = self.ctr
            sc = self.scal.index_select(0, i).view(-1)
            r = self.idx.index_select(0, i).view(-1)
            v, new = self.body(tuple(sc[j] for j in range(self.n_scalars)),
                               self.Xd.index_select(0, r),
                               self.Yd.index_select(0, r), tuple(self.bufs))
            if self.loss is None:
                self.loss = torch.empty_like(v)
            if commit:
                for b, n in zip(self.bufs, new):
                    if n is not b:
                        b.copy_(n)
                self.loss.copy_(v)
                self.ctr.add_(1)

        t0 = time.perf_counter()
        self.graph = engine.capture(step, dev)
        _COUNTS["captures"] += 1
        _COUNTS["capture_s"] += time.perf_counter() - t0
        self.cap_captured = cap
