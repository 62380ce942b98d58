"""NumPy oracle backend.

Plays the role of the reference's pure nested backends ``NTensorL`` /
``NTensorV`` (``src/TensorOps/Backend/NTensor.hs``, ``src/Data/Nested.hs``):
a dead-simple, obviously-correct implementation, float64 throughout, that
the PyTorch backend is validated against.  Contraction follows the
reverse-indexed semantics of ``Nested.gmul'`` (``src/Data/Nested.hs:451-473``)
as a tensordot against reversed contraction axes.

The port's pointwise functions (``VFunc``) are written with torch ops and
their derived gradients come from ``torch.func``, so ``lift`` and
``lift_vjp`` evaluate them on CPU float64 tensors made from the arrays and
hand numpy arrays back.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops.shapes import Shape, ShapeError
from ..ops.vfunc import VFunc
from .base import Backend, Distribution


def _tensors(xs: Sequence[Any]):
    return [torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in xs]


class NumpyBackend(Backend):
    name = "numpy"
    dtype = np.dtype(np.float64)

    def __init__(self, use_native: bool = False):
        """``use_native=True`` routes gmul/transp through the C++ kernels
        in ``native/tensorops_native.cpp`` (the role hmatrix's C BLAS
        plays in the reference); the default stays pure NumPy so the
        oracle and the native path are independent implementations that
        cross-check each other in tests."""
        self.use_native = use_native
        if use_native:
            from ..utils.native import get_lib

            if get_lib() is None:
                raise RuntimeError("native library unavailable (no g++?)")

    def cache_key(self) -> tuple:
        return (self.name, str(self.dtype), self.use_native)

    # -- construction ---------------------------------------------------
    def asarray(self, x: Any) -> np.ndarray:
        return np.asarray(x, dtype=self.dtype)

    def zeros(self, shape: Shape) -> np.ndarray:
        return np.zeros(shape, dtype=self.dtype)

    def ones(self, shape: Shape) -> np.ndarray:
        return np.ones(shape, dtype=self.dtype)

    def konst(self, value: float, shape: Shape) -> np.ndarray:
        return np.full(shape, value, dtype=self.dtype)

    # -- primitives -----------------------------------------------------
    def lift(self, vf: VFunc, xs: Sequence[Any]) -> np.ndarray:
        out = vf.f(*_tensors(xs))
        return np.asarray(torch.as_tensor(out).numpy(), dtype=self.dtype)

    def lift_vjp(self, vf: VFunc, xs: Sequence[Any], ct: Any
                 ) -> Tuple[np.ndarray, ...]:
        gs = vf.derived_grads()(*_tensors(xs))
        gs = [np.asarray(torch.as_tensor(g).numpy(), dtype=self.dtype)
              for g in gs]
        return tuple(np.asarray(ct * g) for g in gs)

    def gmul(self, lm: int, lo: int, ln: int, x: np.ndarray, y: np.ndarray
             ) -> np.ndarray:
        if self.use_native and lo > 0:
            from ..utils.native import native_gmul

            out = native_gmul(lm, lo, ln, x, y)
            if out is not None:
                return np.asarray(out, dtype=self.dtype)
        if lo == 0:
            # outer product: no contraction axes
            return np.multiply.outer(x, y) if (x.ndim or y.ndim) else x * y
        x_axes = list(range(lm, lm + lo))
        y_axes = list(range(lo - 1, -1, -1))  # reversed: Reverse os
        return np.tensordot(x, y, axes=(x_axes, y_axes))

    def transp(self, t: np.ndarray) -> np.ndarray:
        if self.use_native and t.ndim > 1:
            from ..utils.native import native_transpose

            out = native_transpose(t)
            if out is not None:
                return np.asarray(out, dtype=self.dtype)
        return np.transpose(t, axes=tuple(reversed(range(t.ndim))))

    def map_rows(self, k: int, f: Callable, t: np.ndarray) -> np.ndarray:
        if k == 0:
            return np.asarray(f(t), dtype=self.dtype)
        lead = t.shape[:k]
        flat = t.reshape((-1,) + t.shape[k:])
        if flat.shape[0] == 0:
            # empty leading axes: probe f on a zero slice to learn the
            # per-slice output shape
            probe = np.asarray(f(np.zeros(t.shape[k:], dtype=self.dtype)))
            return np.zeros(lead + probe.shape, dtype=self.dtype)
        outs = [np.asarray(f(flat[i]), dtype=self.dtype)
                for i in range(flat.shape[0])]
        return np.stack(outs).reshape(lead + outs[0].shape)

    def sum_rows(self, t: np.ndarray) -> np.ndarray:
        return t.sum(axis=0)

    def diag(self, k: int, v: np.ndarray) -> np.ndarray:
        if k == 1:
            return v.copy()
        n = v.shape[0]
        out = np.zeros((n,) * k, dtype=self.dtype)
        idx = np.arange(n)
        out[(idx,) * k] = v
        return out

    def get_diag(self, k: int, t: np.ndarray) -> np.ndarray:
        idx = np.arange(t.shape[0])
        return t[(idx,) * k]

    def gen_rand(self, dist: Distribution, rng: np.random.Generator,
                 shape: Shape) -> np.ndarray:
        if dist.kind == "custom":
            out = dist.sample(
                self.name, lambda s: rng.uniform(0.0, 1.0, size=s),
                rng, tuple(shape))
            return np.asarray(out, dtype=self.dtype)
        if dist.kind == "normal":
            out = rng.normal(dist.a, dist.b, size=shape)
        elif dist.kind == "uniform":
            out = rng.uniform(dist.a, dist.b, size=shape)
        elif dist.kind == "exponential":
            out = rng.exponential(1.0 / dist.a, size=shape)
        elif dist.kind == "gamma":
            out = rng.gamma(dist.a, dist.b, size=shape)
        else:  # beta
            out = rng.beta(dist.a, dist.b, size=shape)
        return np.asarray(out, dtype=self.dtype)

    def generate(self, shape: Shape, f: Callable[[Tuple[int, ...]], float]
                 ) -> np.ndarray:
        out = np.empty(shape, dtype=self.dtype)
        for idx in np.ndindex(*shape) if shape else [()]:
            out[idx] = f(idx)
        return out

    def ix_rows(self, k: int, f: Callable, t: np.ndarray) -> np.ndarray:
        lead = t.shape[:k]
        if 0 in lead:
            raise ShapeError("ix_rows over an empty leading axis: the slice "
                             "function's output shape is unknowable")
        outs = {idx: np.asarray(f(idx, t[idx]), dtype=self.dtype)
                for idx in np.ndindex(*lead)}
        first = next(iter(outs.values()))
        out = np.empty(lead + first.shape, dtype=self.dtype)
        for idx, v in outs.items():
            out[idx] = v
        return out

    def broadcast_to(self, t: np.ndarray, shape: Shape) -> np.ndarray:
        return np.broadcast_to(t, shape).copy()
