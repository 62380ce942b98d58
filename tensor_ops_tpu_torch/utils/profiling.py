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


def training_memory_report(net, optimizer=None, batch_size: int = 128,
                           mesh=None, shard_opt_state: bool = False,
                           zero_stage: int = None,
                           mixed_precision: bool = False,
                           offload_opt_state: bool = False) -> dict:
    """Analytic bytes per device of ``fit``'s training state for its mesh,
    optimizer, ZeRO and offload options (the JAX package's report).

    Rows: params, gradients (transient in a step, a param's size and
    spec), optimizer moments (0 buffers for sgd, 1 for momentum, 2 for
    adam; ``adam8bit``'s int8 codes and per-block scales from its
    ``(n_blocks, block)`` layout), the bf16 compute copy under
    ``mixed_precision`` and one batch's input rows.  Each row follows the
    rules ``fit`` places by: ``param_specs`` on the mesh, then the ZeRO
    dim-choice rule (the first spec-free dimension the data-axis size dp
    divides) for ZeRO-1 moments (``shard_opt_state`` or ``zero_stage`` >=
    1), ZeRO-2 gradients and ZeRO-3 params; a leaf with no such dimension
    stays whole.  ``adam8bit``'s codes and scales follow the rule on their
    own shapes.  ``offload_opt_state=True`` moves the moment bytes into
    ``optimizer_host_bytes`` (pinned host memory between steps).  The step
    counters of adam are not counted.

    The params and moment rows are what a rank holds between steps: the
    sum of its shards' bytes in a run.  The JAX package's report skips
    ``param_specs`` when the model axis is 1 and so divides a
    row-parallel bias by dp, which its ``fit`` keeps whole; here the
    ``MODEL_AXIS`` entry counts, as it does in placement."""
    import math

    from ..models.optim import moment_footprint
    from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, extend_spec,
                                 param_specs)

    if zero_stage is None:
        zero_stage = 1 if shard_opt_state else 0
    shard_opt_state = shard_opt_state or zero_stage >= 1
    dtype_bytes = _itemsize(net.params[0])
    tp = dp = 1
    specs = [None] * len(net.param_stack)
    if mesh is not None:
        tp = mesh.shape.get(MODEL_AXIS, 1)
        dp = mesh.shape.get(DATA_AXIS, 1)
        specs = param_specs(net.param_stack, mesh)

    def local(shape, spec, zero: bool) -> int:
        """Elements a device holds of a leaf of ``shape`` on ``spec``,
        extended by the data axis when ``zero``."""
        spec = tuple(spec or (None,) * len(shape))
        n = math.prod(shape)
        for ax, s in enumerate(spec):
            if s == MODEL_AXIS and shape[ax] % tp == 0:
                n //= tp
        if zero and extend_spec(spec, shape, dp) is not None:
            n //= dp
        return n

    n_moments = 0
    if optimizer is not None and optimizer.name != "sgd":
        n_moments = 1 if optimizer.name == "momentum" else 2
    params_b = grads_b = moments_b = 0
    for shp, spec in zip(net.param_stack, specs):
        shp = tuple(shp)
        params_b += local(shp, spec, zero_stage >= 3) * dtype_bytes
        grads_b += local(shp, spec, zero_stage >= 2) * dtype_bytes
        if optimizer is not None and optimizer.name == "adam8bit":
            blk = optimizer.hyper[3] if optimizer.hyper else 256
            nb = -(-math.prod(shp) // blk)
            codes = local((nb, blk), None, shard_opt_state)
            scales = local((nb, 1), None, shard_opt_state)
            moments_b += 2 * (codes + scales * dtype_bytes)
        else:
            moments_b += int(moment_footprint(optimizer, dtype_bytes)
                             * local(shp, spec, shard_opt_state))
    compute_b = (params_b // dtype_bytes) * 2 if mixed_precision else 0
    in_elems = math.prod(net.op.in_stack[0])
    batch_b = (batch_size // max(dp, 1)) * in_elems * dtype_bytes
    moments_host_b = 0
    if offload_opt_state:
        moments_host_b, moments_b = moments_b, 0
    total = params_b + grads_b + moments_b + compute_b + batch_b
    return {
        "per_device": {
            "params_bytes": params_b,
            "grads_bytes": grads_b,
            "optimizer_bytes": moments_b,
            "optimizer_host_bytes": moments_host_b,
            "bf16_compute_copy_bytes": compute_b,
            "batch_bytes": batch_b,
            "training_state_total_bytes": total,
        },
        "mesh": {"dp": dp, "tp": tp},
        "zero1": bool(shard_opt_state and dp > 1),
        "zero_stage": zero_stage if dp > 1 else 0,
        "offload_opt_state": bool(offload_opt_state),
        "n_moment_buffers": n_moments,
    }


def _itemsize(x) -> int:
    import numpy as np

    if hasattr(x, "element_size"):
        return x.element_size()
    return np.dtype(x.dtype).itemsize
