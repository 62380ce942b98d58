"""The backend seam: the 13 ``Tensor``-class primitives.

The reference abstracts all storage/compute behind a 13-method typeclass
``Tensor t`` (``src/TensorOps/Types.hs:52-109``: liftT, gmul, sumT, scaleT,
transp, mapRows, sumRows, diag, getDiag, genRand, generateA, ixRows, (!))
with three instances (nested list, nested vector, hmatrix/BLAS).  The
PyTorch port keeps exactly this seam with one instance,
:class:`~tensor_ops_tpu_torch.backend.torch_backend.TorchBackend` (the role
of the reference's ``BTensor``/hmatrix BLAS backend,
``src/TensorOps/Backend/BTensor.hs``): every ``gmul`` is one
``torch.tensordot``, so the 971-line rank-dispatch of the reference
collapses into one call.  The JAX package's ``JaxBackend`` is the
reference this backend is tested against.

`gmul` semantics (reference ``src/TensorOps/Types.hs:60-66``): given
``x : ms ++ os`` and ``y : Reverse os ++ ns`` produce ``ms ++ ns`` by
contracting x's trailing ``os`` axes against y's leading axes *in reversed
order*::

    out[m..., n...] = sum_{o1..ok} x[m..., o1..ok] * y[ok..o1, n...]
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

from ..ops.shapes import Shape
from ..ops.vfunc import VFunc


class Distribution:
    """Element-i.i.d. continuous distribution spec for ``gen_rand``
    (reference parameterizes ``genRand`` by any statistics ``ContGen``,
    ``src/TensorOps/Types.hs:93-96``).  Five common kinds are built in;
    ``custom`` expresses ANY continuous distribution via its inverse CDF
    (exactly a ``ContGen``'s content) or per-backend native samplers."""

    __slots__ = ("kind", "a", "b")

    KINDS = ("normal", "uniform", "exponential", "gamma", "beta")

    def __init__(self, kind: str, a: float, b: float = 1.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown distribution kind {kind!r}")
        self.kind = kind
        self.a = float(a)
        self.b = float(b)

    def __repr__(self):
        return f"Distribution({self.kind}, {self.a}, {self.b})"


class CustomDistribution(Distribution):
    """A user-supplied continuous distribution for ``gen_rand`` — the
    full ``ContGen`` parameterization of the reference's ``genRand``
    (``src/TensorOps/Types.hs:93-96``), not just the five built-ins.

    Two (composable) ways to specify it:

    * ``icdf``: the inverse CDF (quantile function), applied elementwise
      to U(0,1) draws (write it with ``torch`` ops).  This is exactly
      what a statistics ``ContGen`` instance closes over.
    * ``samplers``: per-backend native samplers ``{"torch": f}`` where
      ``f(torch_generator, shape)`` returns a tensor — for distributions
      with better-than-inversion samplers.  A backend falls back to
      ``icdf`` when it has no native sampler.
    """

    __slots__ = ("icdf", "samplers", "label")

    def __init__(self, icdf: "Callable[[Any], Any] | None" = None,
                 samplers: "dict | None" = None, name: str = "custom"):
        if icdf is None and not samplers:
            raise ValueError(
                "custom distribution needs an inverse CDF (icdf=) and/or "
                "per-backend samplers ({'torch': f})")
        # deliberately NOT calling Distribution.__init__: kind 'custom'
        # is recognized structurally (isinstance) by the backends
        self.kind = "custom"
        self.a = 0.0
        self.b = 0.0
        self.icdf = icdf
        self.samplers = dict(samplers or {})
        self.label = name

    def sample(self, backend_name: str, uniform01, rng, shape):
        """Backend hook: native sampler if registered, else inverse-CDF
        transform of ``uniform01(shape)`` (a U(0,1) draw)."""
        f = self.samplers.get(backend_name)
        if f is not None:
            return f(rng, shape)
        if self.icdf is None:
            raise ValueError(
                f"CustomDistribution({self.label}): no sampler "
                f"registered for backend {backend_name!r} (have "
                f"{sorted(self.samplers)}) and no icdf= fallback")
        return self.icdf(uniform01(shape))

    def __repr__(self):
        return f"CustomDistribution({self.label})"


def normal(mean: float = 0.0, std: float = 1.0) -> Distribution:
    return Distribution("normal", mean, std)


def uniform(lo: float = 0.0, hi: float = 1.0) -> Distribution:
    return Distribution("uniform", lo, hi)


def exponential(rate: float = 1.0) -> Distribution:
    return Distribution("exponential", rate)


def gamma(shape: float, scale: float = 1.0) -> Distribution:
    return Distribution("gamma", shape, scale)


def beta(a: float, b: float) -> Distribution:
    return Distribution("beta", a, b)


def custom(icdf=None, samplers=None, name: str = "custom") -> CustomDistribution:
    """Any continuous distribution, by inverse CDF and/or per-backend
    samplers — closes the reference's full ``ContGen`` parameterization
    (``src/TensorOps/Types.hs:93-96``).  Example (Laplace)::

        import torch
        lap = custom(icdf=lambda u: -torch.sign(u - 0.5)
                     * torch.log1p(-2 * torch.abs(u - 0.5)), name="laplace")
        rng.draw(lap, (3, 4))
    """
    return CustomDistribution(icdf=icdf, samplers=samplers, name=name)


class Backend:
    """Abstract backend: the 13 Tensor primitives plus array utilities.

    Array values are whatever the backend produces (``torch.Tensor``);
    the IR layer treats them as opaque.
    """

    name: str = "abstract"

    def cache_key(self) -> tuple:
        """Identity of everything that changes evaluation semantics —
        used to key the per-op caches.  Subclasses append their settings
        (dtype, device); two backends with equal keys must compute
        identically."""
        return (self.name, str(getattr(self, "dtype", None)))

    # -- construction / conversion ------------------------------------
    def asarray(self, x: Any) -> Any:
        raise NotImplementedError

    def zeros(self, shape: Shape) -> Any:
        raise NotImplementedError

    def ones(self, shape: Shape) -> Any:
        raise NotImplementedError

    def konst(self, value: float, shape: Shape) -> Any:
        """Constant-filled tensor (helper ``TT.konst``,
        ``src/TensorOps/Tensor.hs:49-54``)."""
        raise NotImplementedError

    # -- the 13 Tensor primitives --------------------------------------
    def lift(self, vf: VFunc, xs: Sequence[Any]) -> Any:
        """Pointwise lift of an n-ary scalar function over n same-shape
        tensors (``liftT``, ``src/TensorOps/Types.hs:56-59``)."""
        return vf.f(*xs)

    def lift_vjp(self, vf: VFunc, xs: Sequence[Any], ct: Any) -> Tuple[Any, ...]:
        """VJP of a pointwise lift: ``dx_i = ct * (grad f(x))_i`` per
        element (``TT.gradLift``, ``src/TensorOps/Tensor.hs:119-129``)."""
        gs = vf.derived_grads()(*xs)
        return tuple(ct * g for g in gs)

    def gmul(self, lm: int, lo: int, ln: int, x: Any, y: Any) -> Any:
        """Generalized contraction (``gmul``,
        ``src/TensorOps/Types.hs:60-66``); see module docstring."""
        raise NotImplementedError

    def sum_list(self, ts: Sequence[Any], shape: Shape) -> Any:
        """Sum a (possibly empty) list of same-shape tensors; the empty
        list is the zero tensor (``sumT``, ``src/TensorOps/Types.hs:69``;
        empty-list zero semantics used by ``shuffle``/``drop``/``take``
        gradients, ``src/TensorOps/TOp.hs:106-131,362-381``)."""
        if not ts:
            return self.zeros(shape)
        acc = ts[0]
        for t in ts[1:]:
            acc = acc + t
        return acc

    def scale(self, alpha: float, t: Any) -> Any:
        """``scaleT`` (``src/TensorOps/Types.hs:70``)."""
        return alpha * t

    def transp(self, t: Any) -> Any:
        """Full index reversal (``transp``,
        ``src/TensorOps/Types.hs:71-73``)."""
        raise NotImplementedError

    def map_rows(self, k: int, f: Callable[[Any], Any], t: Any) -> Any:
        """Apply ``f`` to each slice over the leading ``k`` axes
        (``mapRows``, ``src/TensorOps/Types.hs:77-81``)."""
        raise NotImplementedError

    def sum_rows(self, t: Any) -> Any:
        """Sum over the leading axis (``sumRows``,
        ``src/TensorOps/Types.hs:82-84``)."""
        return t.sum(axis=0)

    def diag(self, k: int, v: Any) -> Any:
        """Embed a vector as the diagonal of a rank-``k`` tensor
        (``diag``, ``src/TensorOps/Types.hs:85-88``)."""
        raise NotImplementedError

    def get_diag(self, k: int, t: Any) -> Any:
        """Extract the diagonal of a rank-``k`` (k>=2) tensor
        (``getDiag``, ``src/TensorOps/Types.hs:89-92``)."""
        raise NotImplementedError

    def gen_rand(self, dist: Distribution, rng: Any, shape: Shape) -> Any:
        """Element-i.i.d. sampling (``genRand``,
        ``src/TensorOps/Types.hs:93-96``). ``rng`` is backend-specific:
        a ``torch.Generator`` for :class:`TorchBackend`."""
        raise NotImplementedError

    def generate(self, shape: Shape, f: Callable[[Tuple[int, ...]], float]) -> Any:
        """Build a tensor from an index function (``generateA``,
        ``src/TensorOps/Types.hs:97-99``)."""
        raise NotImplementedError

    def ix_rows(self, k: int, f: Callable[[Tuple[int, ...], Any], Any], t: Any) -> Any:
        """Indexed map over slices of the leading ``k`` axes (``ixRows``,
        ``src/TensorOps/Types.hs:100-106``)."""
        raise NotImplementedError

    def index(self, t: Any, idx: Tuple[int, ...]) -> Any:
        """Scalar indexing (``(!)``, ``src/TensorOps/Types.hs:107-109``)."""
        return t[tuple(idx)]

    # -- helpers used by the AD engine ---------------------------------
    def broadcast_to(self, t: Any, shape: Shape) -> Any:
        raise NotImplementedError

    def shape_of(self, t: Any) -> Shape:
        return tuple(t.shape)
