"""The traced part of a ``--trace 1`` run: the benchmark's own spans, and
``torch.profiler`` over a steady part of the window, reduced to what the
per-layer readers take.

A traced run profiles two parts of its window, one after the other.  The
first records the device alone: its events give the busy time (the union
of the intervals in which a kernel, copy or memset ran), the device
operations by name, and the idle gaps, each named by the innermost of
the benchmark's spans around it.  The second records the host's runtime
calls too, which gives the launches the host issued; recording every
host call slows the host, so that part's wall time is not read.  Spans and device events share the wall clock in
nanoseconds (``time.time_ns``, which the profiler's timestamps follow).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the runtime calls by which the host launches work on the card
HOST_LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                   "cudaGraphLaunch")


class Spans:
    """Spans the benchmark records around its calls into the program:
    ``[name, start_ns, end_ns]`` in wall-clock nanoseconds, the end None
    while the span is open; ``mark`` records one of no length."""

    def __init__(self):
        self.done: List[list] = []

    def span(self, name: str):
        return _Span(self, name)

    def mark(self, name: str) -> None:
        t = time.time_ns()
        self.done.append([name, t, t])

    def upto(self, t_ns: int) -> List[Tuple[str, int, int]]:
        """The spans as they stand at ``t_ns``, an open one ending there."""
        return [(n, a, t_ns if b is None else b) for n, a, b in self.done]


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rec = [self.name, time.time_ns(), None]
        self.spans.done.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        return False


@dataclass
class TraceData:
    """One traced part: its host-clock length ``window_s``, the device's
    busy seconds in it, device operations (kernels, copies, memsets) and
    host launches counted, and the breakdown."""

    window_s: float
    busy_s: float
    device_ops: int
    host_launches: Optional[int]
    top_ops: List[List] = field(default_factory=list)
    idle_gaps: List[List] = field(default_factory=list)


def _kernel_name(raw: str) -> str:
    name = raw.replace("(anonymous namespace)::", "")
    name = name.replace("void ", "").split("(")[0].split("<")[0]
    return name.split("::")[-1] or raw[:60]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _name_gap(spans, s: int, e: int) -> str:
    """A gap from ``s`` to ``e`` is named by a mark (a span of no length)
    inside it, else by the innermost span around its middle."""
    mid = (s + e) // 2
    best = None
    for name, t0, t1 in spans:
        if t0 == t1 and s <= t0 <= e:
            return name
        if t0 <= mid <= t1 and (best is None or t1 - t0 < best[0]):
            best = (t1 - t0, name)
    return best[1] if best else "outside the benchmark's spans"


def reduce(events, t0_ns: int, t1_ns: int, window_s: float,
           spans, host_events: bool = True) -> TraceData:
    """A ``TraceData`` from the profiler's raw events (``_KinetoEvent``s)
    of a part that ran from ``t0_ns`` to ``t1_ns`` (the host's launches
    None where ``host_events`` were not recorded)."""
    from torch.autograd import DeviceType

    intervals, by_name = [], {}
    host = 0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            d = e.duration_ns()
            intervals.append((s, s + d))
            n = _kernel_name(e.name())
            by_name[n] = by_name.get(n, 0) + d
        elif e.name() in HOST_LAUNCH_API:
            host += 1
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged)
    spans = [sp for sp in spans if sp[1] <= t1_ns and sp[2] >= t0_ns]
    gaps: Dict[str, int] = {}
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            n = _name_gap(spans, s, e)
            gaps[n] = gaps.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(window_s=window_s, busy_s=busy * 1e-9,
                     device_ops=len(intervals),
                     host_launches=host if host_events else None,
                     top_ops=[[n, ns * 1e-9] for n, ns in top],
                     idle_gaps=[[n, ns * 1e-9] for n, ns in idle])


class Tracer:
    """``torch.profiler`` over parts of a window that the driver starts
    and stops (on the thread that drives the program): first the device
    part (``data``), then the host part, whose launches go into ``data``.
    ``warm`` profiles nothing once in set-up, so the profiler's own
    start-up stays out of the window."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.data: Optional[TraceData] = None
        self._prof = None
        self._host = False

    def warm(self) -> None:
        self.start(host_events=True)
        self._prof.stop()
        self._prof = None

    @property
    def running(self) -> bool:
        return self._prof is not None

    @property
    def done(self) -> bool:
        """Both parts are read."""
        return self.data is not None and self.data.host_launches is not None

    def start(self, host_events: Optional[bool] = None) -> None:
        """Start profiling the next part: the device's events, and with
        ``host_events`` (by default: once the device part is read) the
        runtime calls of the host too (``ProfilerActivity.CPU``, which
        records on every thread; a driver whose program runs on threads of
        its own profiles the device alone)."""
        from torch.profiler import ProfilerActivity, profile

        if host_events is None:
            host_events = self.data is not None
        acts = [ProfilerActivity.CUDA]
        if host_events:
            acts.append(ProfilerActivity.CPU)
        self._host = host_events
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0_ns, self._t0 = time.time_ns(), time.perf_counter()

    def stop(self) -> Optional[TraceData]:
        """Stop (the card is synchronised first) and reduce; None when the
        profiler handed back no device event.  A host part after the
        device part only adds its launches to ``data``."""
        import torch

        torch.cuda.synchronize()
        t1, t1_ns = time.perf_counter(), time.time_ns()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        data = reduce(events, self._t0_ns, t1_ns, t1 - self._t0,
                      self.spans.upto(t1_ns), self._host)
        if data.device_ops == 0:
            return None
        if self._host and self.data is not None:
            self.data.host_launches = data.host_launches
        else:
            self.data = data
        return data
