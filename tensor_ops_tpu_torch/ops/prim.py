"""The primitive op library — every constructor from the reference's
``src/TensorOps/TOp.hs`` (see SURVEY.md §2.1), as eager-shape-checked IR
builders.

Stack convention matches the reference: an op's inputs/outputs are ordered
stacks of tensors; ``lead`` (Haskell ``*>>``) pipes an op into the prefix
of another's inputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .ir import (
    BroadcastRows,
    Diag,
    Fanout,
    First,
    GetDiag,
    GMul,
    Identity,
    Konst,
    LiftOp,
    Par,
    Replicate,
    Scale,
    Second,
    Shuffle,
    SumOp,
    SumRows,
    TOp,
    Transp,
)
from .shapes import as_shape, as_stack
from .vfunc import VFunc, vfunc1, vfunc2, vfuncN

# -- structure ---------------------------------------------------------------


def identity(stack: Sequence) -> TOp:
    """``idOp`` (``Types.hs:159-163``)."""
    return Identity(stack)


def first(op: TOp, rest: Sequence) -> TOp:
    return First(op, rest)


def second(op: TOp, front: Sequence) -> TOp:
    return Second(op, front)


def par(f: TOp, g: TOp) -> TOp:
    return Par(f, g)


def fanout(f: TOp, g: TOp) -> TOp:
    return Fanout(f, g)


def lead(f: TOp, g: TOp) -> TOp:
    """``f *>> g`` (``Types.hs:204-211``)."""
    return f.lead(g)


def shuffle(in_stack: Sequence, idxs: Sequence[int]) -> TOp:
    """``TO.shuffle`` by indices (``TOp.hs:106-131``)."""
    return Shuffle(in_stack, idxs)


def swap(s1: Sequence[int], s2: Sequence[int]) -> TOp:
    """``TO.swap`` (``TOp.hs:346-351``)."""
    return Shuffle((as_shape(s1), as_shape(s2)), (1, 0))


def swap_blocks(front: Sequence, back: Sequence) -> TOp:
    """``TO.swap' lN lM : (ns ++ ms) -> (ms ++ ns)`` (``TOp.hs:353-360``)."""
    f, b = as_stack(front), as_stack(back)
    n, m = len(f), len(b)
    return Shuffle(f + b, tuple(range(n, n + m)) + tuple(range(n)))


def drop(front: Sequence, rest: Sequence) -> TOp:
    """``TO.drop lN : (ns ++ ms) -> ms`` — drops the leading ``front``;
    dropped slots get zero gradients (``TOp.hs:362-370``)."""
    f, r = as_stack(front), as_stack(rest)
    return Shuffle(f + r, tuple(range(len(f), len(f) + len(r))))


def take(front: Sequence, rest: Sequence) -> TOp:
    """``TO.take lN lM : (ns ++ ms) -> ns`` (``TOp.hs:372-381``)."""
    f, r = as_stack(front), as_stack(rest)
    return Shuffle(f + r, tuple(range(len(f))))


# -- pointwise ---------------------------------------------------------------


def lift_op(vf: VFunc, shape: Sequence[int]) -> TOp:
    """``liftOp`` (``TOp.hs:42-54``)."""
    return LiftOp(vf, shape)


def map_op(
    shape: Sequence[int],
    f: Callable,
    df: Optional[Callable] = None,
    name: str = "map",
) -> TOp:
    """``TO.map`` / ``TO.map'`` (``TOp.hs:198-213``); derivative derived
    with ``torch.func.grad`` when ``df`` is None (the reference uses the
    ``ad`` package)."""
    return LiftOp(vfunc1(f, df, name), shape)


def zip_op(
    shape: Sequence[int],
    f: Callable,
    df: Optional[Callable] = None,
    name: str = "zip",
) -> TOp:
    """``TO.zip`` / ``TO.zip'`` (``TOp.hs:249-266``)."""
    return LiftOp(vfunc2(f, df, name), shape)


def zip3_op(
    shape: Sequence[int],
    f: Callable,
    df: Optional[Callable] = None,
    name: str = "zip3",
) -> TOp:
    """``TO.zip3`` / ``TO.zip3'`` (``TOp.hs:268-285``)."""
    return LiftOp(vfuncN(3, f, df, name), shape)


def zipn_op(
    n: int,
    shape: Sequence[int],
    f: Callable,
    df: Optional[Callable] = None,
    name: str = "zipN",
) -> TOp:
    """``TO.zipN`` / ``TO.zipN'`` (``TOp.hs:232-247``)."""
    return LiftOp(vfuncN(n, f, df, name), shape)


# -- arithmetic / structure primitives ----------------------------------------


def add(shape: Sequence[int]) -> TOp:
    """``TO.add`` (``TOp.hs:215-221``)."""
    return SumOp(2, shape)


def add3(shape: Sequence[int]) -> TOp:
    """``TO.add3`` (``TOp.hs:223-229``)."""
    return SumOp(3, shape)


def sum_op(n: int, shape: Sequence[int]) -> TOp:
    """``TO.sumOp`` (``TOp.hs:161-169``)."""
    return SumOp(n, shape)


def scale(shape: Sequence[int], alpha: float) -> TOp:
    """``TO.scale`` (``TOp.hs:171-177``)."""
    return Scale(shape, alpha)


def negate(shape: Sequence[int]) -> TOp:
    """``TO.negate`` (``TOp.hs:194-196``)."""
    return Scale(shape, -1.0)


def konst(value: float, shape: Sequence[int], n: int = 1) -> TOp:
    """``TO.konst`` (``TOp.hs:185-192``)."""
    return Konst(value, shape, n)


def replicate_op(shape: Sequence[int], n: int) -> TOp:
    """``TO.replicate`` (``TOp.hs:287-293``)."""
    return Replicate(shape, n)


def duplicate(shape: Sequence[int]) -> TOp:
    """``TO.duplicate`` (``TOp.hs:295-302``)."""
    return Replicate(shape, 2)


def sum_rows(shape: Sequence[int]) -> TOp:
    """``TO.sumRows`` (``TOp.hs:151-159``)."""
    return SumRows(shape)


def broadcast_rows(shape: Sequence[int], n: int) -> TOp:
    """Adjoint of ``sum_rows``: one tensor broadcast to ``n`` stacked
    rows (the batched-lowering bias primitive)."""
    return BroadcastRows(shape, n)


def transp_op(shape: Sequence[int]) -> TOp:
    """``TO.transpOp`` (``TOp.hs:97-104``)."""
    return Transp(shape)


def diag_op(n: int, k: int) -> TOp:
    return Diag(n, k)


def get_diag_op(n: int, k: int) -> TOp:
    return GetDiag(n, k)


# -- contraction family --------------------------------------------------------


def gmul(ms: Sequence[int], os: Sequence[int], ns: Sequence[int]) -> TOp:
    """``TO.gmul`` (``TOp.hs:56-94``)."""
    return GMul(ms, os, ns)


def inner(ms: Sequence[int], o: int, ns: Sequence[int]) -> TOp:
    """``TO.inner``: contract one shared axis ``o`` — in stack
    ``[ms ++ [o], [o] ++ ns]`` (``TOp.hs:304-311``)."""
    return GMul(ms, (o,), ns)


def outer(ms: Sequence[int], ns: Sequence[int]) -> TOp:
    """``TO.outer`` (``TOp.hs:313-320``)."""
    return GMul(ms, (), ns)


def dot(m: int) -> TOp:
    """``TO.dot : [[m],[m]] -> [[]]`` (``TOp.hs:322-325``)."""
    return GMul((), (m,), ())


def mat_vec(m: int, n: int) -> TOp:
    """``TO.matVec : [[m,n],[n]] -> [[m]]`` (``TOp.hs:327-331``)."""
    return GMul((m,), (n,), ())


def vec_mat(m: int, n: int) -> TOp:
    """``TO.vecMat : [[m],[m,n]] -> [[n]]`` (``TOp.hs:333-337``)."""
    return GMul((), (m,), (n,))


def mat_mat(m: int, n: int, o: int) -> TOp:
    """``TO.matMat : [[m,n],[n,o]] -> [[m,o]]`` (``TOp.hs:339-343``)."""
    return GMul((m,), (n,), (o,))


def remat(op: TOp) -> TOp:
    """Checkpoint ``op``: keep only its inputs as residuals and recompute
    the forward during the backward pass (``loops.Remat``)."""
    from .loops import Remat

    return Remat(op)
