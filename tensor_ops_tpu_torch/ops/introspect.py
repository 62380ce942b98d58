"""Op-graph inspection: tree rendering and statistics.

The reference's "yay dependent types" ergonomics (``README.md:140-142``)
come from GHC printing the op's type; the staged-IR analog is printing
the graph itself — every node with its stack signature, indented by
structure — plus quick size/depth statistics.  Debugging aid only; no
evaluation happens here.

All traversals are iterative (explicit stacks): a then-chained or
unrolled network can easily exceed Python's recursion limit in depth.
Children are discovered generically from the node classes' ``__slots__``
(any attribute or tuple/list element that is a :class:`TOp`), so new
node types are covered without registering anything here.

A copy of ``tensor_ops_tpu/ops/introspect.py`` (framework-free) on this
package's ``ops.ir`` and ``ops.shapes``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .ir import TOp
from .shapes import fmt_stack


_SLOT_CACHE: Dict[type, Tuple[str, ...]] = {}


def _candidate_slots(cls: type) -> Tuple[str, ...]:
    """The class's public slot names (MRO-wide), computed once per node
    class — ``children`` runs once per node in every traversal, so the
    MRO walk must not repeat."""
    names = _SLOT_CACHE.get(cls)
    if names is None:
        seen = []
        for c in cls.__mro__:
            for name in getattr(c, "__slots__", ()):
                if not name.startswith("_") and name not in seen:
                    seen.append(name)
        names = tuple(seen)
        _SLOT_CACHE[cls] = names
    return names


def children(op: TOp) -> List[Tuple[str, TOp]]:
    """The node's child ops as ``(attr_name, child)`` pairs, discovered
    from ``__slots__`` across the class hierarchy (Compose's f/g,
    First/Second/Mapped/Remat's op, ScanOp's step, and any future node
    shape — including children held in tuples/lists)."""
    out: List[Tuple[str, TOp]] = []
    for name in _candidate_slots(type(op)):
        v = getattr(op, name, None)
        if isinstance(v, TOp):
            out.append((name, v))
        elif isinstance(v, (tuple, list)):
            out.extend(
                (f"{name}[{i}]", c)
                for i, c in enumerate(v) if isinstance(c, TOp))
    return out


def count_nodes(op: TOp) -> int:
    n = 0
    stack = [op]
    while stack:
        o = stack.pop()
        n += 1
        stack.extend(c for _, c in children(o))
    return n


def describe(op: TOp, max_depth: int = 0) -> str:
    """Multi-line tree rendering of an op graph::

        Compose({[2], [3,2], [3]} -> {[3]})
        ├─f: First({[2], [3,2]} -> {[3]})
        │  └─op: Compose({[2], [3,2]} -> {[3]})
        ...

    ``max_depth > 0`` truncates deeper structure with an ellipsis node
    (useful for then-chained / unrolled networks)."""
    lines: List[str] = []
    # work stack of (node, prefix, child_prefix, name, depth); children
    # are pushed reversed so the leftmost child renders first
    stack = [(op, "", "", "", 0)]
    while stack:
        o, prefix, child_prefix, name, depth = stack.pop()
        label = f"{name}: " if name else ""
        lines.append(f"{prefix}{label}{o!r}")
        kids = children(o)
        if kids and max_depth and depth >= max_depth:
            lines.append(f"{child_prefix}└─... ({count_nodes(o) - 1} more "
                         f"nodes)")
            continue
        for i in range(len(kids) - 1, -1, -1):
            attr, c = kids[i]
            last = i == len(kids) - 1
            stack.append((
                c,
                child_prefix + ("└─" if last else "├─"),
                child_prefix + ("   " if last else "│  "),
                attr, depth + 1))
    return "\n".join(lines)


def graph_stats(op: TOp) -> Dict[str, object]:
    """Size/shape summary of an op graph: total node count, structural
    depth, leaf-node histogram, and the stack signature."""
    by_type: Dict[str, int] = {}
    n = 0
    max_depth = 0
    stack = [(op, 0)]
    while stack:
        o, d = stack.pop()
        n += 1
        kids = children(o)
        if not kids:
            by_type[type(o).__name__] = by_type.get(type(o).__name__, 0) + 1
            max_depth = max(max_depth, d)
        else:
            stack.extend((c, d + 1) for _, c in kids)
    return {
        "nodes": n,
        "depth": max_depth,
        "leaves": dict(sorted(by_type.items())),
        "signature": f"{fmt_stack(op.in_stack)} -> {fmt_stack(op.out_stack)}",
    }
