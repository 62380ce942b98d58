"""Optimizers.

The reference knows only per-sample SGD (``p - r*g`` inline in
``trainNetwork``, ``FeedForward.hs:141-147``).  As in the JAX package, that
stays the default beside the standard updaters, each a pure transform of a
tuple of parameters with its state threaded explicitly.  The state of each
optimizer has the JAX package's structure (adam's is ``(t, m, v)``) and its
``hyper``, so a ``.state`` checkpoint passes between the packages.  The
updates work on torch tensors and on the NumPy oracle's arrays alike.

On tensors every value that changes from step to step is read from the
device: ``lr`` may be a 0-d tensor, adam's step count ``t`` is a 0-d int32
tensor on the parameters' device (the JAX package's traced int), its bias
corrections ``1 - b**t`` are computed there, and
``adam8bit``'s rounding noise is a counter-based hash of the step tensor.
Nothing in an update reads the device from the host, so a step can be
captured in a CUDA graph and replayed (``models/chain.py``).  On the NumPy
oracle ``t`` stays a Python int and the numbers are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
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
    # set by adam8bit(exact_reduction=True): under ZeRO stages >= 2 on a
    # mesh the batch gradients keep the replicated run's all-reduce (kernel
    # 9's ar, then each rank's slice) instead of a reduce-scatter, so the
    # run equals the replicated one bit for bit (trainer._mesh_setup); on
    # one device there is one order and the flag only keys caches and
    # checkpoints (through hyper)
    exact_reduction: bool = False

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


def _step0(params):
    """Adam's step count before the first update: a 0-d int32 tensor on the
    parameters' device for tensors, the int 0 on the NumPy oracle."""
    if params and isinstance(params[0], torch.Tensor):
        return torch.zeros((), dtype=torch.int32, device=params[0].device)
    return 0


def _next_step(t, params):
    """``t + 1``, a tensor on the parameters' device when they are tensors
    (a Python ``t``, or a tensor elsewhere, as a caller may hand in, is
    moved there first)."""
    if params and isinstance(params[0], torch.Tensor):
        dev = params[0].device
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(int(t), dtype=torch.int32, device=dev)
        elif t.device != dev:
            t = t.to(dev)
    return t + 1


def _bias_corrections(t, b1: float, b2: float, like):
    """``(1 - b1**t, 1 - b2**t)``: for a tensor ``t`` computed on its
    device in float64 and rounded once to ``like``'s dtype (the value a
    float64 host computation divides by, and the JAX package's traced-int
    step in x64); in Python floats for an int ``t``."""
    if isinstance(t, torch.Tensor):
        tf = t.to(torch.float64)
        return ((1 - b1 ** tf).to(like.dtype), (1 - b2 ** tf).to(like.dtype))
    return 1 - b1**t, 1 - b2**t


def _adam_impl(b1: float, b2: float, eps: float, weight_decay: float):
    """The one adam update both :func:`adam` and :func:`adamw` wrap.
    ``weight_decay`` is DECOUPLED (multiplies the parameter, never the
    moments); 0.0 reproduces classic adam bit for bit."""

    def init(params):
        return (_step0(params), tuple(p * 0 for p in params),
                tuple(p * 0 for p in params))

    def update(state, params, grads, lr):
        t, m, v = state
        t = _next_step(t, params)
        m = tuple(b1 * mi + (1 - b1) * g for mi, g in zip(m, grads))
        v = tuple(b2 * vi + (1 - b2) * g * g for vi, g in zip(v, grads))
        c1, c2 = _bias_corrections(t, b1, b2, params[0])
        mc = tuple(mi / c1 for mi in m)
        vc = tuple(vi / c2 for vi in v)
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


_SR_SALT = 0xA8B17  # stream id of adam8bit's rounding noise, fixed forever
_M32 = 0xFFFFFFFF


def _mix32(h):
    """A 32-bit integer finalizer (xor-shift-multiply rounds) on int64
    tensors holding values in [0, 2**32).  The multipliers are odd and below
    2**31, so no product leaves int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    h = h ^ (h >> 13)
    h = (h * 0x297A2D39) & _M32
    return h ^ (h >> 16)


def _sr_uniform(t, stream: int, like):
    """U(0, 1) noise of ``like``'s shape for stochastic rounding, a pure
    function of (step ``t``, leaf stream id, element).  On NumPy arrays the
    JAX package's own numpy stream (``default_rng((salt, t, stream))``).
    On torch tensors a counter-based hash computed on the tensor's device
    from (salt, ``t``, stream, element index), ``t`` an int or a 0-d tensor
    there: no generator is seeded from the host, so a step that draws it
    can be replayed from a CUDA graph.  The torch stream is not the JAX
    package's (threefry): it is held by its properties, not by equal
    bits."""
    if isinstance(like, torch.Tensor):
        dev = like.device
        t = torch.as_tensor(t, dtype=torch.int64, device=dev)
        key = _mix32((t & _M32) ^ ((_SR_SALT * 0x9E37 + int(stream)
                                    * 0x61C8864F) & _M32))
        idx = torch.arange(like.numel(), dtype=torch.int64, device=dev)
        h = _mix32(_mix32((idx & _M32) ^ key) ^ (idx >> 32))
        # the top 24 bits as a float in [0, 1): exact in every float dtype
        u = (h >> 8).to(like.dtype) * (1.0 / (1 << 24))
        return u.reshape(like.shape)
    return np.random.default_rng(
        (_SR_SALT, int(t), int(stream))).uniform(size=like.shape)


def adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             block: int = 256, stochastic_rounding: bool = False,
             exact_reduction: bool = False) -> Optimizer:
    """Adam with block-wise 8-bit moments (the JAX package's ``adam8bit``,
    the bitsandbytes recipe with symmetric per-block absmax): m and v are
    int8 codes with one scale per ``block`` elements, a quarter of f32
    adam's optimizer memory.  The update dequantizes, steps in full
    precision and requantizes; parameters stay full precision.

    m rounds to nearest, or with ``stochastic_rounding=True`` unbiasedly
    (``floor(x/s + u)``, u ~ U(0, 1) from :func:`_sr_uniform`), and v then
    rounds away from zero (it sits under the step's square root, where an
    underestimate explodes a step).  The noise is a pure function of the
    step and the leaf index, so crash/resume chains stay bit-exact.
    ``exact_reduction`` keeps the batch gradients of a ZeRO-2/3 mesh run on
    the replicated run's all-reduce (a reduce-scatter sums in another
    order, and the int8 quantization amplifies that epsilon); the update
    itself is the same, and the flag keys caches and checkpoints.

    State: ``(t, ((mq, ms, vq, vs), ...))``, ``mq``/``vq`` int8
    ``(n_blocks, block)`` and ``ms``/``vs`` ``(n_blocks, 1)`` in the
    parameter's dtype; the JAX package's layout, so ``.state`` files pass
    between the packages."""

    def _q(x, t=None, stream=0, mode="nearest"):
        # x: (n_blocks, block) -> int8 codes + per-block scale
        if isinstance(x, torch.Tensor):
            s = x.abs().amax(dim=1, keepdim=True) / 127.0
            y = x / torch.where(s > 0, s, torch.ones_like(s))
            if mode == "sr" and t is not None:
                y = torch.floor(y + _sr_uniform(t, stream, x))
            elif mode == "ceil":
                y = torch.sign(y) * torch.ceil(y.abs())
            else:
                y = torch.round(y)  # half to even, as rint
            return torch.clamp(y, -127, 127).to(torch.int8), s.to(x.dtype)
        s = np.max(np.abs(x), axis=1, keepdims=True) / 127.0
        y = x / np.where(s > 0, s, 1.0)
        if mode == "sr" and t is not None:
            y = np.floor(y + _sr_uniform(t, stream, x))
        elif mode == "ceil":
            y = np.sign(y) * np.ceil(np.abs(y))
        else:
            y = np.rint(y)
        return np.clip(y, -127, 127).astype("int8"), s.astype(x.dtype)

    def _blocks(g):
        n = g.numel() if isinstance(g, torch.Tensor) else g.size
        nb = -(-n // block)
        if isinstance(g, torch.Tensor):
            flat = g.reshape(-1)
            if nb * block != n:
                flat = torch.cat([flat, flat.new_zeros(nb * block - n)])
        else:
            flat = np.ravel(g)
            if nb * block != n:
                flat = np.concatenate(
                    [flat, np.zeros((nb * block - n,), flat.dtype)])
        return flat.reshape(nb, block)

    def init(params):
        state = []
        for p in params:
            zq, zs = _q(_blocks(p * 0))
            state.append((zq, zs, zq, zs))
        return (_step0(params), tuple(state))

    def update(state, params, grads, lr):
        t, qs = state
        t = _next_step(t, params)
        c1, c2 = _bias_corrections(t, b1, b2, params[0]) if params else (1, 1)
        mmode = "sr" if stochastic_rounding else "nearest"
        vmode = "ceil" if stochastic_rounding else "nearest"
        new_qs, new_params = [], []
        for idx, (p, g, (mq, ms, vq, vs)) in enumerate(
                zip(params, grads, qs)):
            gb = _blocks(g)
            m = b1 * (mq * ms) + (1 - b1) * gb
            v = b2 * (vq * vs) + (1 - b2) * gb * gb
            mc = m / c1
            vc = v / c2
            n = p.numel() if isinstance(p, torch.Tensor) else p.size
            step = (lr * mc / (vc**0.5 + eps)).reshape(-1)[:n]
            new_params.append(p - step.reshape(p.shape))
            new_qs.append(_q(m, t=t, stream=2 * idx, mode=mmode)
                          + _q(v, t=t, stream=2 * idx + 1, mode=vmode))
        return (t, tuple(new_qs)), tuple(new_params)

    # the JAX package's hyper: its historical 4-tuple by default, a flag
    # appended for stochastic rounding and a marker for exact_reduction
    hyper = ((b1, b2, eps, block, True) if stochastic_rounding
             else (b1, b2, eps, block))
    if exact_reduction:
        hyper = hyper + ("exact",)
    return Optimizer(init, update, "adam8bit", hyper=hyper,
                     exact_reduction=exact_reduction)


def moment_footprint(opt: Optional[Optimizer], dtype_bytes: int) -> float:
    """Bytes of optimizer state PER PARAMETER ELEMENT: 0 for sgd, one
    full-precision buffer for momentum, two for adam and adamw, two 1-byte
    code buffers plus their per-block scales for adam8bit.  Unknown
    stateful optimizers default to adam's footprint."""
    if opt is None or opt.name == "sgd":
        return 0.0
    if opt.name == "momentum":
        return float(dtype_bytes)
    if opt.name == "adam8bit":
        block = opt.hyper[3] if opt.hyper else 256
        return 2.0 * (1.0 + dtype_bytes / block)
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
