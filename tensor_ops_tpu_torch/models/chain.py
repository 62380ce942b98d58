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
"""

from __future__ import annotations

import gc
import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

_COUNTS = {"captures": 0, "capture_s": 0.0, "replays": 0}


def chain_counts() -> dict:
    """``{"captures", "capture_s", "replays"}`` of this process: graphs
    captured, the host seconds their warm-up and capture took, and the
    graph launches made by chained windows."""
    return dict(_COUNTS)


def reset_chain_counts() -> None:
    _COUNTS.update(captures=0, capture_s=0.0, replays=0)


def uses_graphs(device) -> bool:
    """Whether a chained window on ``device`` replays a CUDA graph."""
    return torch.device(device).type == "cuda"


def flatten(tree) -> List[Any]:
    """The leaves of a tree of tuples and lists (``None`` is empty), in
    order: the training state ``(params, opt_state, ema)``."""
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
    """A step could not be captured in a CUDA graph."""


def _failing_op(err: BaseException) -> str:
    """``function (file:line: code)`` of the innermost frame of ``err``'s
    traceback outside torch and outside this module: the operation of the
    step (or of a caller's optimizer) that broke capture."""
    here = os.path.abspath(__file__)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    frames = traceback.extract_tb(err.__traceback__)
    own = [f for f in frames if os.path.abspath(f.filename) != here
           and not os.path.abspath(f.filename).startswith(torch_dir)]
    f = (own or frames)[-1]
    return f"{f.name} ({f.filename}:{f.lineno}: {(f.line or '').strip()})"


def _clear_cublas_workspaces() -> None:
    """Drop the cuBLAS workspaces torch keeps per (handle, stream): the
    next cuBLAS call on a stream allocates its own anew.  A torch built
    without CUDA has none (and no such call)."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def capture(fn: Callable[[bool], Any], device,
            what: str = "the training step",
            remedy: str = ("a chained window is never run eagerly on the "
                           "card; pass chain_steps=1 to train unchained"),
            stream: Optional["torch.cuda.Stream"] = None
            ) -> "torch.cuda.CUDAGraph":
    """Run ``fn(False)`` once on a side stream (warm-up: cuBLAS handles,
    workspaces and the caching allocator's blocks), then capture one call
    of ``fn(True)`` into a new CUDA graph and return it.

    With no ``stream`` the side stream is a new one and a full garbage
    collection runs first, which frees the graphs and blocks of earlier
    windows.  A caller that passes ``stream`` holds no reference cycle
    over its graphs and gets no collection (it would stall every other
    thread of the process): ``stream`` is then the side stream and the
    capture's too (else the capture's is torch's own), so that what the
    kernels keep per stream is made by the warm-up, outside the capture.

    torch keeps one cuBLAS workspace per (handle, stream), and streams
    come from a pool and recur.  The workspaces are dropped before the
    warm-up, before the capture and after it, as ``torch.compile``'s
    graphs do: a captured cuBLAS call then writes a workspace allocated
    inside the capture, which the graph's own memory pool keeps, and no
    warm-up or later call on the same stream writes it while the graph
    replays.  Raises :class:`CaptureError` naming ``what`` was captured,
    the operation that broke capture and the caller's ``remedy``."""
    t0 = time.perf_counter()
    device = torch.device(device)
    # a collection inside the capture could destroy an unreachable graph,
    # which a capturing stream refuses (the capture is then invalidated):
    # collect first (unless the caller's graphs hold no cycles), and never
    # during it
    if stream is None:
        gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        cur = torch.cuda.current_stream(device)
        side = stream if stream is not None else torch.cuda.Stream(device)
        side.wait_stream(cur)
        _clear_cublas_workspaces()
        with torch.cuda.stream(side):
            fn(False)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        _clear_cublas_workspaces()
        on = {} if stream is None else {"stream": stream}
        with torch.cuda.graph(graph, capture_error_mode="thread_local",
                              **on):
            fn(True)
        _clear_cublas_workspaces()
        torch.cuda.synchronize(device)
    except Exception as err:  # noqa: BLE001 — re-raised with its site
        raise CaptureError(
            f"capturing {what} in a CUDA graph failed at "
            f"{_failing_op(err)}: {type(err).__name__}: {err} — "
            f"{remedy}") from err
    finally:
        if collecting:
            gc.enable()
    _COUNTS["captures"] += 1
    _COUNTS["capture_s"] += time.perf_counter() - t0
    return graph


class StepChain:
    """Windows of ``body`` over the resident dataset ``(Xd, Yd)``.

    ``body(scalars, xb, yb, leaves) -> (loss, new_leaves)`` is one training
    step on the flat state ``leaves`` (:func:`flatten` order), ``scalars``
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
        if not uses_graphs(self.device) or rows.shape[1] != self.batch:
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

        self.graph = capture(step, dev)
        self.cap_captured = cap
