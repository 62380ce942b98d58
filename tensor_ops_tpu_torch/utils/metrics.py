"""Step-metrics logging: JSONL/CSV alongside the reference's stdout UX
(the reference prints per-batch errors and confusion matrices only,
``app/MNIST.hs:335-356``; SURVEY.md §5 asks for optional structured
metrics on top)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, TextIO


class MetricsLogger:
    """Append-only JSONL metrics with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[TextIO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.perf_counter()

    def log(self, step: int, **metrics: Any) -> Dict[str, Any]:
        rec = {"step": step, "t": round(time.perf_counter() - self._t0, 4)}
        rec.update(
            {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        )
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
