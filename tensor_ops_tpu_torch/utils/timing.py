"""Wall-clock phase timing (the reference's ``time`` helper,
``app/Dots.hs:158-166`` / ``app/MNIST.hs:413-421``), made honest on an
asynchronous device: ``block`` waits for every CUDA tensor in the result
before the clock is read."""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

from .profiling import _sync


def block(x: Any) -> Any:
    """Wait until every CUDA tensor in ``x`` (a tensor or a nest of
    tuples, lists and dicts of them) is computed; return ``x``."""
    _sync(x)
    return x


def timed(f: Callable) -> Tuple[Any, float]:
    """Run ``f()``, force the result, return (result, seconds)."""
    t0 = time.perf_counter()
    out = block(f())
    t1 = time.perf_counter()
    return out, t1 - t0
