"""Value-level tensor helper API — the rebuild of
``src/TensorOps/Tensor.hs`` (konst/map/zip/inner/outer/dot/matVec/matMat/
fromList/generate/toList/oneHot/argMax/argMin, ``Tensor.hs:14-25``),
implemented generically over any
:class:`~tensor_ops_tpu_torch.backend.base.Backend`: the port of
``tensor_ops_tpu/tensor.py``.  The helpers that read elements copy a
tensor to the host first (:func:`_host`), wherever it lies.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from .backend.base import Backend
from .ops.shapes import Shape, ShapeError, as_shape
from .ops.vfunc import VFunc, vfunc1, vfunc2, vfuncN


def _host(x: Any) -> np.ndarray:
    """``x`` as a host array (a tensor copied off its device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def konst(be: Backend, value: float, shape: Sequence[int]) -> Any:
    """``TT.konst`` (``Tensor.hs:49-54``)."""
    return be.konst(value, as_shape(shape))


def tmap(be: Backend, f: Callable, x: Any, df: Optional[Callable] = None) -> Any:
    """``TT.map`` (``Tensor.hs:56-63``)."""
    return be.lift(vfunc1(f, df), (x,))


def tzip(be: Backend, f: Callable, x: Any, y: Any) -> Any:
    """``TT.zip`` (``Tensor.hs:65-75``)."""
    return be.lift(vfunc2(f), (x, y))


def tzipN(be: Backend, f: Callable, *xs: Any) -> Any:
    """``TT.zipN`` (``Tensor.hs:77-85``)."""
    return be.lift(vfuncN(len(xs), f), xs)


def tadd(be: Backend, x: Any, y: Any) -> Any:
    """``TT.add`` (``Tensor.hs:87-93``)."""
    return be.sum_list([x, y], be.shape_of(x))


def grad_lift(be: Backend, vf: VFunc, xs: Sequence[Any], ct: Any):
    """``TT.gradLift`` — pointwise VJP (``Tensor.hs:119-129``)."""
    return be.lift_vjp(vf, xs, ct)


def inner(be: Backend, lm: int, ln: int, x: Any, y: Any) -> Any:
    """``TT.inner`` (``Tensor.hs:132-142``)."""
    return be.gmul(lm, 1, ln, x, y)


def outer(be: Backend, x: Any, y: Any) -> Any:
    """``TT.outer`` (``Tensor.hs:144-153``)."""
    return be.gmul(len(be.shape_of(x)), 0, len(be.shape_of(y)), x, y)


def outer_v(be: Backend, x: Any, y: Any) -> Any:
    """``TT.outerV`` — vector (x) vector outer product (``Tensor.hs:155-156``)."""
    return be.gmul(1, 0, 1, x, y)


def dot(be: Backend, x: Any, y: Any) -> Any:
    """``TT.dot`` (``Tensor.hs:158-163``)."""
    return be.gmul(0, 1, 0, x, y)


def mat_vec(be: Backend, m: Any, v: Any) -> Any:
    """``TT.matVec`` (``Tensor.hs:165-170``)."""
    return be.gmul(1, 1, 0, m, v)


def vec_mat(be: Backend, v: Any, m: Any) -> Any:
    """``TT.vecMat`` (``Tensor.hs:172-177``)."""
    return be.gmul(0, 1, 1, v, m)


def mat_mat(be: Backend, a: Any, b: Any) -> Any:
    """``TT.matMat`` (``Tensor.hs:179-185``)."""
    return be.gmul(1, 1, 1, a, b)


def from_list(be: Backend, xs: Sequence[float], shape: Sequence[int]) -> Any:
    """``TT.fromList`` — fill row-major from a flat list, erroring on
    length mismatch (``Tensor.hs:187-191``)."""
    shape = as_shape(shape)
    n = int(np.prod(shape)) if shape else 1
    xs = list(xs)
    if len(xs) != n:
        raise ShapeError(f"fromList: expected {n} elements for {shape}, got {len(xs)}")
    return be.asarray(np.asarray(xs, dtype=np.float64).reshape(shape))


def generate(be: Backend, shape: Sequence[int], f: Callable) -> Any:
    """``TT.generate`` (``Tensor.hs:193-199``)."""
    return be.generate(as_shape(shape), f)


def rows(be: Backend, x: Any) -> List[Any]:
    """Leading-axis slices (``TT.rows``/``TT.toRows``,
    ``Tensor.hs:201-215``)."""
    return [x[i] for i in range(be.shape_of(x)[0])]


def ix_elems(be: Backend, f: Callable, x: Any) -> Any:
    """Indexed elementwise rebuild (``TT.ixElems``, ``Tensor.hs:217-236``)."""
    arr = _host(x).astype(np.float64)
    out = np.empty_like(arr)
    for idx in np.ndindex(*arr.shape) if arr.shape else [()]:
        out[idx] = f(idx, float(arr[idx]))
    return be.asarray(out)


def elems(be: Backend, x: Any) -> List[float]:
    """All elements row-major (``TT.elems``, ``Tensor.hs:238-246``)."""
    return to_list(be, x)


def ito_list(be: Backend, x: Any) -> List[tuple]:
    """Indexed element list (``TT.itoList``, ``Tensor.hs:248-260``)."""
    arr = _host(x)
    return [(idx, float(arr[idx])) for idx in
            (np.ndindex(*arr.shape) if arr.shape else [()])]


def to_list(be: Backend, x: Any) -> List[float]:
    """``TT.toList`` — row-major element list (``Tensor.hs:262-268``)."""
    return [float(v) for v in _host(x).reshape(-1)]


def un_scalar(be: Backend, x: Any) -> float:
    """``TT.unScalar`` (``Tensor.hs:270-273``)."""
    return float(_host(x).reshape(()))


def one_hot(be: Backend, on: float, off: float, index: int, n: int) -> Any:
    """``TT.oneHot`` (``Tensor.hs:275-289``)."""
    out = np.full((n,), off, dtype=np.float64)
    out[index] = on
    return be.asarray(out)


def arg_max(be: Backend, x: Any) -> int:
    """``TT.argMax`` (``Tensor.hs:291-305``)."""
    return int(_host(x).reshape(-1).argmax())


def arg_min(be: Backend, x: Any) -> int:
    """``TT.argMin`` (``Tensor.hs:307-321``)."""
    return int(_host(x).reshape(-1).argmin())
