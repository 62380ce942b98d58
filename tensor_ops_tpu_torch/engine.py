"""Engine: cached callables for whole op graphs.

The JAX package traces each graph once per (graph, backend, mode) into one
jitted XLA program.  PyTorch runs eagerly, so here ``maybe_jit`` is the
identity and each callable evaluates the graph node by node; the bounded
per-op ``_compiled`` caches stay, so a composed graph (and, later, a
captured CUDA graph) is built once per key.
"""

from __future__ import annotations

from typing import Callable

from .backend.base import Backend
from .ops import ir
from .ops.ir import TOp


def _key(be: Backend, mode: str) -> tuple:
    return be.cache_key() + (mode,)


def compile_run(op: TOp, be: Backend) -> Callable:
    """Forward: ``fn(*xs) -> ys_tuple``."""
    key = _key(be, "run")
    fn = op._compiled.get(key)
    if fn is None:

        def fwd(*xs):
            return op.apply(be, tuple(xs))

        fn = maybe_jit(fwd, be)
        op._compiled[key] = fn
    return fn


def compile_grad(op: TOp, be: Backend) -> Callable:
    """Gradient of a scalar-output graph: ``fn(*xs) -> grads_tuple``
    (the staged ``gradTOp``)."""
    key = _key(be, "grad")
    fn = op._compiled.get(key)
    if fn is None:

        def gradf(*xs):
            return ir.grad(op, be, xs)

        fn = maybe_jit(gradf, be)
        op._compiled[key] = fn
    return fn


def compile_value_and_grad(op: TOp, be: Backend) -> Callable:
    key = _key(be, "vag")
    fn = op._compiled.get(key)
    if fn is None:

        def vag(*xs):
            return ir.value_and_grad(op, be, xs)

        fn = maybe_jit(vag, be)
        op._compiled[key] = fn
    return fn


def compile_vjp(op: TOp, be: Backend) -> Callable:
    """General VJP: ``fn(xs_tuple, cts_tuple) -> grads_tuple``."""
    key = _key(be, "vjp")
    fn = op._compiled.get(key)
    if fn is None:

        def vjpf(xs, cts):
            return ir.vjp(op, be, xs, cts)

        fn = maybe_jit(vjpf, be)
        op._compiled[key] = fn
    return fn


def maybe_jit(fn: Callable, be: Backend) -> Callable:
    """Identity: PyTorch executes eagerly (the JAX package jits here)."""
    return fn
