"""PyTorch backend — the GPU compute path.

Plays the role of the reference's BLAS-accelerated ``BTensor`` backend
(``src/TensorOps/Backend/BTensor.hs``) and of the JAX package's
``JaxBackend``: every ``gmul`` case is one ``torch.tensordot`` (cuBLAS on
the card; in bf16 on the card, a bf16 product on the tensor cores), and
execution is eager.

Pointwise-lift VJPs use ``torch.func.vjp`` of the (elementwise) function at
the tensor level, which is exactly the per-element gradient the reference
computes via ``TT.gradLift`` (``src/TensorOps/Tensor.hs:119-129``).
Dtype and device are explicit on every tensor the backend makes; the
global default dtype is never touched.  The device is the card unless the
caller names another.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops.shapes import Shape, ShapeError
from ..ops.vfunc import VFunc
from .base import Backend, Distribution


def _bf16_tensordot(x: torch.Tensor, y: torch.Tensor, dims) -> torch.Tensor:
    """A bf16 ``tensordot`` with ``allow_bf16_reduced_precision_reduction``
    off for the call and restored after it."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return torch.tensordot(x, y, dims=dims)
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


class TorchBackend(Backend):
    name = "torch"

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device: "str | torch.device" = "cuda"):
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {dtype!r}")
        self.dtype = dtype
        self.device = torch.device(device)

    def cache_key(self) -> tuple:
        return (self.name, str(self.dtype), str(self.device))

    def _t(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- construction ---------------------------------------------------
    def asarray(self, x: Any) -> torch.Tensor:
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch refuses read-only numpy buffers
        return self._t(x)

    def zeros(self, shape: Shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape: Shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def konst(self, value: float, shape: Shape) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    # -- primitives -----------------------------------------------------
    def lift(self, vf: VFunc, xs: Sequence[Any]) -> torch.Tensor:
        return self._t(vf.f(*xs))

    def lift_vjp(self, vf: VFunc, xs: Sequence[Any], ct: Any
                 ) -> Tuple[torch.Tensor, ...]:
        if vf.grads is not None:
            gs = vf.grads(*xs)
            return tuple(ct * self._t(g) for g in gs)
        # elementwise function => tensor-level vjp == per-element vjp
        _, pullback = torch.func.vjp(vf.f, *xs)
        return tuple(pullback(ct))

    def gmul(self, lm: int, lo: int, ln: int, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Contract x's trailing ``lo`` axes with y's leading ``lo`` axes
        in REVERSED order (``jax_backend.py:73-84``).  bf16 accumulates in
        f32 and rounds once to bf16, as the JAX backend's
        ``preferred_element_type=f32`` then ``astype(bf16)`` does: on the
        card one bf16 cuBLAS product on the tensor cores with its f32
        reduction kept (no reduced-precision split-K, the flag set for
        this call only), elsewhere the operands upcast to f32."""
        contract_x = list(range(lm, lm + lo))
        contract_y = list(range(lo - 1, -1, -1))
        if self.dtype == torch.bfloat16 and self.device.type == "cuda":
            return _bf16_tensordot(x.to(self.dtype), y.to(self.dtype),
                                   (contract_x, contract_y))
        acc = torch.float32 if self.dtype == torch.bfloat16 else self.dtype
        x = torch.as_tensor(x, device=self.device).to(acc)
        y = torch.as_tensor(y, device=self.device).to(acc)
        out = torch.tensordot(x, y, dims=(contract_x, contract_y))
        return out.to(self.dtype)

    def transp(self, t: torch.Tensor) -> torch.Tensor:
        return t.permute(tuple(reversed(range(t.ndim))))

    def map_rows(self, k: int, f: Callable, t: torch.Tensor) -> torch.Tensor:
        if k == 0:
            return self._t(f(t))
        lead = tuple(t.shape[:k])
        flat = t.reshape((-1,) + tuple(t.shape[k:]))
        if flat.shape[0] == 0:
            # vmap refuses a 0-sized axis: probe f on one zero slice to
            # learn the per-slice output shape
            probe = self._t(f(self.zeros(tuple(t.shape[k:]))))
            return self.zeros(lead + tuple(probe.shape))
        out = torch.func.vmap(f)(flat)
        return out.reshape(lead + tuple(out.shape[1:]))

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t.sum(dim=0)

    def diag(self, k: int, v: torch.Tensor) -> torch.Tensor:
        if k == 1:
            return v
        n = v.shape[0]
        idx = torch.arange(n, device=self.device)
        return self.zeros((n,) * k).index_put((idx,) * k, v)

    def get_diag(self, k: int, t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0]
        idx = torch.arange(n, device=self.device)
        return t[(idx,) * k]

    def gen_rand(self, dist: Distribution, rng: torch.Generator,
                 shape: Shape) -> torch.Tensor:
        """Draws from ``rng`` (a ``torch.Generator`` on this backend's
        device).  Numbers differ from the JAX backend's threefry draws for
        the same seed; only the distributions agree."""
        shape = tuple(shape)
        kw = dict(generator=rng, dtype=self.dtype, device=self.device)
        if dist.kind == "custom":
            out = dist.sample(self.name, lambda s: torch.rand(tuple(s), **kw),
                              rng, shape)
            return self._t(out)
        if dist.kind == "normal":
            return dist.a + dist.b * torch.randn(shape, **kw)
        if dist.kind == "uniform":
            return dist.a + (dist.b - dist.a) * torch.rand(shape, **kw)
        if dist.kind == "exponential":
            return torch.empty(shape, dtype=self.dtype,
                               device=self.device).exponential_(
                                   dist.a, generator=rng)
        if dist.kind == "gamma":
            return dist.b * self._std_gamma(dist.a, shape, rng)
        g1 = self._std_gamma(dist.a, shape, rng)
        g2 = self._std_gamma(dist.b, shape, rng)
        return g1 / (g1 + g2)  # Beta(a, b) from two standard gammas

    def _std_gamma(self, alpha: float, shape: Shape,
                   rng: torch.Generator) -> torch.Tensor:
        conc = torch.full(shape, alpha, dtype=self.dtype, device=self.device)
        return torch._standard_gamma(conc, generator=rng)

    def generate(self, shape: Shape, f: Callable[[Tuple[int, ...]], float]
                 ) -> torch.Tensor:
        out = np.empty(shape, dtype=np.float64)
        for idx in np.ndindex(*shape) if shape else [()]:
            out[idx] = f(idx)
        return self._t(out)

    def ix_rows(self, k: int, f: Callable, t: torch.Tensor) -> torch.Tensor:
        lead = tuple(t.shape[:k])
        if 0 in lead:
            raise ShapeError("ix_rows over an empty leading axis: the slice "
                             "function's output shape is unknowable")
        rows = [self._t(f(idx, t[idx])) for idx in np.ndindex(*lead)]
        out = torch.stack(rows)
        return out.reshape(lead + tuple(rows[0].shape))

    def broadcast_to(self, t: torch.Tensor, shape: Shape) -> torch.Tensor:
        return torch.broadcast_to(t, tuple(shape))
