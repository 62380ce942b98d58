"""Step timing (SURVEY.md §5).

The reference's only instrumentation is a wall-clock ``time`` helper with
deepseq forcing (``app/Dots.hs:158-166``).  The port keeps the JAX
package's :class:`StepTimer`, with the device sync done the PyTorch way:
CUDA work is asynchronous, so ``stop(result)`` synchronises the result's
device before it reads the clock."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List


def _sync(result) -> None:
    """Wait for every CUDA tensor in ``result`` (a tensor or a nest of
    tuples/lists/dicts of them) to be computed."""
    import torch

    stack = [result]
    devices = set()
    while stack:
        r = stack.pop()
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, (tuple, list)):
            stack.extend(r)
        elif isinstance(r, dict):
            stack.extend(r.values())
    for d in devices:
        torch.cuda.synchronize(d)


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
