"""Shape and stack algebra — the trace-time replacement for the reference's
type-level shape system.

The reference (mstksg/tensor-ops) indexes every tensor operation by a
type-level list of shapes (``TOp ns ms`` over ``ns, ms :: [[k]]``,
reference ``src/TensorOps/Types.hs:122-125``), so dimension mismatches are
compile errors.  Here a *shape* is a plain ``tuple[int, ...]`` and a *stack*
(the heterogeneous list of tensor shapes flowing through an op) is a
``tuple[Shape, ...]``; every combinator validates its operands eagerly at
graph-construction time and raises :class:`ShapeError` with a precise
message, so errors never surface deep inside a tensor library call.

This module replaces, at trace time, the whole type-level utility layer of
the reference (``src/Data/Type/*``, ``src/Type/*`` — singletons, ``Length``,
``Uniform``, ``Prod`` manipulation; see SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

Shape = Tuple[int, ...]
Stack = Tuple[Shape, ...]

SCALAR: Shape = ()


class ShapeError(TypeError):
    """Raised at graph-construction time on any stack/shape mismatch.

    The rebuild's analog of a GHC type error from mismatched ``TOp``
    composition (reference README.md:140-142: composition of mismatched
    ops "does not typecheck")."""


def as_shape(s: Iterable[int] | int) -> Shape:
    """Normalize ``s`` to a Shape. Accepts an int (rank-1), or an iterable
    of ints. Scalars are the empty tuple ``()``."""
    if isinstance(s, int):
        return (s,)
    t = tuple(s)
    for d in t:
        if not isinstance(d, int) or isinstance(d, bool) or d < 0:
            raise ShapeError(f"invalid dimension {d!r} in shape {t!r}")
    return t


def as_stack(stack: Sequence[Iterable[int] | int]) -> Stack:
    """Normalize a sequence of shapes to a Stack."""
    return tuple(as_shape(s) for s in stack)


def fmt_shape(s: Shape) -> str:
    return "[" + ",".join(map(str, s)) + "]"


def fmt_stack(st: Stack) -> str:
    return "{" + ", ".join(fmt_shape(s) for s in st) + "}"


def check_stack_eq(where: str, got: Stack, want: Stack) -> None:
    if tuple(got) != tuple(want):
        raise ShapeError(
            f"{where}: stack mismatch\n  expected {fmt_stack(tuple(want))}\n"
            f"  got      {fmt_stack(tuple(got))}"
        )


def check_prefix(where: str, stack: Stack, prefix: Stack) -> Stack:
    """Check that ``stack`` begins with ``prefix``; return the remainder."""
    k = len(prefix)
    if tuple(stack[:k]) != tuple(prefix):
        raise ShapeError(
            f"{where}: stack prefix mismatch\n"
            f"  expected prefix {fmt_stack(tuple(prefix))}\n"
            f"  got stack       {fmt_stack(tuple(stack))}"
        )
    return tuple(stack[k:])


def size(s: Shape) -> int:
    n = 1
    for d in s:
        n *= d
    return n
