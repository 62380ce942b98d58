"""Optimizers.

The reference knows only per-sample SGD (``p - r*g`` inline in
``trainNetwork``, ``FeedForward.hs:141-147``).  As in the JAX package, that
stays the default beside the standard updaters, each a pure transform of a
tuple of parameters with its state threaded explicitly.  The state of each
optimizer has the JAX package's structure (adam's is ``(t, m, v)`` with an
int ``t``) and its ``hyper``, so a ``.state`` checkpoint passes between
the packages.  The updates work on torch tensors and on the NumPy oracle's
arrays alike.  ``adam8bit`` waits for its own parity design (ROADMAP.md,
Queue 1 item 5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

Params = Tuple[Any, ...]
Grads = Tuple[Any, ...]


class Optimizer(NamedTuple):
    """(init, update): update(state, params, grads, lr) -> (state, new_params).

    ``hyper`` is the structural identity of the update rule (the
    hyperparameters the factory closed over): two optimizers with equal
    (name, hyper) compute identical updates, so caches survive
    reconstruction (``fit(..., optimizer=adam())`` in a loop) and a
    checkpoint records which rule wrote its moments.  Custom optimizers may
    leave it None to key caches by object identity."""

    init: Callable[[Params], Any]
    update: Callable[[Any, Params, Grads, float], Tuple[Any, Params]]
    name: str = "optimizer"
    hyper: Optional[tuple] = None

    def struct_key(self) -> tuple:
        if self.hyper is not None:
            return (self.name, self.hyper)
        return (self.name, "id", id(self.update))


def sgd() -> Optimizer:
    """Plain SGD — the reference's update rule."""

    def init(params):
        return ()

    def update(state, params, grads, lr):
        return (), tuple(p - lr * g for p, g in zip(params, grads))

    return Optimizer(init, update, "sgd", hyper=())


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tuple(p * 0 for p in params)

    def update(state, params, grads, lr):
        vel = tuple(beta * v + g for v, g in zip(state, grads))
        if nesterov:
            step = tuple(beta * v + g for v, g in zip(vel, grads))
        else:
            step = vel
        return vel, tuple(p - lr * s for p, s in zip(params, step))

    return Optimizer(init, update, "momentum", hyper=(beta, nesterov))


def _adam_impl(b1: float, b2: float, eps: float, weight_decay: float):
    """The one adam update both :func:`adam` and :func:`adamw` wrap.
    ``weight_decay`` is DECOUPLED (multiplies the parameter, never the
    moments); 0.0 reproduces classic adam bit for bit."""

    def init(params):
        return (0, tuple(p * 0 for p in params),
                tuple(p * 0 for p in params))

    def update(state, params, grads, lr):
        t, m, v = state
        t = t + 1
        m = tuple(b1 * mi + (1 - b1) * g for mi, g in zip(m, grads))
        v = tuple(b2 * vi + (1 - b2) * g * g for vi, g in zip(v, grads))
        # bias correction
        mc = tuple(mi / (1 - b1**t) for mi in m)
        vc = tuple(vi / (1 - b2**t) for vi in v)
        new_params = tuple(
            p - lr * (mi / ((vi**0.5) + eps) + weight_decay * p)
            for p, mi, vi in zip(params, mc, vc))
        return (t, m, v), new_params

    return init, update


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    init, update = _adam_impl(b1, b2, eps, 0.0)
    return Optimizer(init, update, "adam", hyper=(b1, b2, eps))


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """AdamW — adam with DECOUPLED weight decay (Loshchilov & Hutter):
    ``p -= lr*wd*p`` beside the adaptive step, outside the moments."""
    init, update = _adam_impl(b1, b2, eps, weight_decay)
    return Optimizer(init, update, "adamw",
                     hyper=(b1, b2, eps, weight_decay))


def moment_footprint(opt: Optional[Optimizer], dtype_bytes: int) -> float:
    """Bytes of optimizer state PER PARAMETER ELEMENT: 0 for sgd, one
    full-precision buffer for momentum, two for adam and adamw.  Unknown
    stateful optimizers default to adam's footprint.  ``adam8bit``'s
    branch comes with ``adam8bit`` (ROADMAP.md, Queue 1 item 5)."""
    if opt is None or opt.name == "sgd":
        return 0.0
    if opt.name == "momentum":
        return float(dtype_bytes)
    return 2.0 * dtype_bytes


def clip_by_global_norm(grads: Grads, max_norm: float) -> Grads:
    """Scale the gradients so their global L2 norm is <= max_norm.  On
    torch tensors the scale stays on the device (no synchronise)."""
    total = 0.0
    for g in grads:
        total = total + (g * g).sum()
    norm = total ** 0.5
    if isinstance(norm, torch.Tensor):
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    else:
        scale = min(max_norm / (float(norm) + 1e-12), 1.0)
    return tuple(g * scale for g in grads)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.0):
    """lr(step): cosine decay from base_lr to final_frac * base_lr."""

    def lr(step: int) -> float:
        t = min(step, total_steps) / max(total_steps, 1)
        return base_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * t)))

    return lr


def exponential_schedule(base_lr: float, decay: float, every: int = 1):
    """lr(step) = base_lr * decay**(step // every)."""

    def lr(step: int) -> float:
        return base_lr * decay ** (step // every)

    return lr
