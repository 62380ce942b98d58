"""Pointwise scalar functions with gradients (``VFunc``).

The reference packages an R^n -> R scalar function together with its
gradient as ``VFunc n`` (``src/TensorOps/Types.hs:114-117``) and, when the
user supplies only the function, derives the gradient with the ``ad``
package (``src/TensorOps/TOp.hs:213,246``).  Here a :class:`VFunc` holds a
function built from elementwise primitives (it is applied to whole arrays,
not scalars — pointwise semantics are preserved because every constituent
op is elementwise) plus optional closed-form partial derivatives; when the
derivatives are absent they are derived with ``torch.func.grad`` on the
scalar signature, mapped with ``torch.func.vmap``: PyTorch's analog of the
``ad`` package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


class _Unfreezable(Exception):
    pass


def _freeze(v):
    """A hashable token that is equal iff the values are interchangeable;
    raises when we can't be sure (mutable/opaque objects)."""
    import types

    if isinstance(v, (int, float, complex, str, bytes, bool, type(None))):
        # type name included: hash(1) == hash(1.0) but 1 and 1.0 behave
        # differently under e.g. integer division
        return (type(v).__name__, v)
    if isinstance(v, tuple):
        return ("tuple",) + tuple(_freeze(x) for x in v)
    if isinstance(v, types.ModuleType):
        return ("mod", v.__name__)  # module identity is its import name
    if isinstance(v, types.CodeType):
        return ("codeobj", v.co_filename, v.co_firstlineno, v.co_code)
    if callable(v):
        return callable_key(v)
    raise _Unfreezable(v)


def callable_key(f) -> tuple:
    """A structural identity for a callable: equal keys imply equal
    behavior.  Plain functions/lambdas key on their code object plus ALL
    frozen captured state — closure cells, defaults, and the values of
    every global name the code references (modules key by name; opaque
    values are unprovable) — so structurally identical functions built
    at the same code site compare equal across calls: the cache-key fix
    for the ``fit(net, cross_entropy(o))`` recompile-per-call pattern.

    Anything we can't prove equal falls back to ``id``: bound methods
    (behavior depends on ``__self__`` state), builtins/callable objects,
    and functions capturing opaque values.  Callers must then pin the
    object in the cache value so the id cannot be recycled."""
    if f is None:
        return ("none",)
    if getattr(f, "__self__", None) is not None:
        # bound method: two methods sharing __code__ on objects in
        # different states behave differently — never key structurally
        return ("id", id(f))
    code = getattr(f, "__code__", None)
    if code is None:
        return ("id", id(f))
    if id(f) in _keying:  # self/mutually-recursive global references
        return ("rec", code.co_filename, code.co_firstlineno)
    _keying.add(id(f))
    try:
        cells = tuple(
            _freeze(c.cell_contents) for c in (f.__closure__ or ())
        )
        defaults = tuple(_freeze(d) for d in (f.__defaults__ or ()))
        # referenced globals: same code text with different global
        # bindings (exec-built factories, monkeypatched modules) is
        # different behavior
        g = getattr(f, "__globals__", None) or {}
        gvals = tuple(
            sorted((n, _freeze(g[n])) for n in set(code.co_names)
                   if n in g)
        )
        consts = tuple(_freeze(c) for c in code.co_consts)
    except _Unfreezable:
        return ("id", id(f))
    finally:
        _keying.discard(id(f))
    return ("code", code.co_filename, code.co_firstlineno,
            code.co_code, cells, defaults, gvals, consts)


_keying: set = set()


@dataclass(frozen=True)
class VFunc:
    """A pointwise function R^n -> R and its partial derivatives.

    ``f`` maps n same-shape arrays elementwise to one array.  ``grads``,
    if given, maps the n input arrays to the n arrays of partials
    (evaluated elementwise).  ``name`` keys caches and error messages.
    """

    n_args: int
    f: Callable
    grads: Optional[Callable] = None
    name: str = "vfunc"

    def __post_init__(self):
        if self.n_args < 0:
            raise ValueError("VFunc arity must be >= 0")

    def struct_key(self) -> tuple:
        """Structural identity for caches: equal keys imply equal
        pointwise behavior (see :func:`callable_key`)."""
        return ("vf", self.n_args, self.name,
                callable_key(self.f), callable_key(self.grads))

    def derived_grads(self) -> Callable:
        """Partial-derivative function: closed-form if supplied, else
        derived via ``torch.func.grad`` of the scalar signature and
        evaluated elementwise with ``torch.func.vmap`` over the flattened
        tensors."""
        if self.grads is not None:
            return self.grads
        return _autodiff_grads(self.f, self.n_args)


def _autodiff_grads(f: Callable, n_args: int) -> Callable:
    """Derive elementwise partials with ``torch.func.grad`` + ``vmap``.
    Built per call: map/zip functions are usually fresh lambdas, so
    identity-keyed caching would only leak memory, and this path is not
    performance-sensitive."""
    import torch
    from torch.func import grad, vmap

    g_scalar = grad(f, argnums=tuple(range(n_args)))

    def grads(*xs):
        xs = [torch.as_tensor(x) for x in xs]
        shape = xs[0].shape
        outs = vmap(g_scalar)(*(x.reshape(-1) for x in xs))
        return tuple(o.reshape(shape) for o in outs)

    return grads


def vfunc1(f: Callable, df: Optional[Callable] = None, name: str = "map") -> VFunc:
    """Unary pointwise function (reference ``TO.map'``/``TO.map``,
    ``src/TensorOps/TOp.hs:198-213``)."""
    grads = None if df is None else (lambda x: (df(x),))
    return VFunc(1, f, grads, name)


def vfunc2(f: Callable, df: Optional[Callable] = None, name: str = "zip") -> VFunc:
    """Binary pointwise function (reference ``TO.zip'``/``TO.zip``,
    ``src/TensorOps/TOp.hs:249-266``). ``df(x, y) -> (dx, dy)``."""
    return VFunc(2, f, df, name)


def vfuncN(n: int, f: Callable, df: Optional[Callable] = None, name: str = "zipN") -> VFunc:
    """N-ary pointwise function (reference ``TO.zipN``,
    ``src/TensorOps/TOp.hs:232-247``)."""
    return VFunc(n, f, df, name)
