"""The segment matching of ``tensor_ops_tpu/parallel/ir_pipeline.py``: a
network's layer sub-graphs (:func:`network_segments`) and the row-parallel
(Megatron) split of an ffLayer segment over the model axis
(:func:`_tp_local_segment_split`, :func:`_tp_local_segment`), under the
JAX package's names.  The tensor-parallel executor (:mod:`.tp`) runs on
them.

The rest of that module, the staged-IR pipelines over a ``stage`` mesh
axis and their tensor-parallel routes, is not ported yet (ROADMAP.md,
Queue 1 items 9c-2 and 9c-3; the GPipe and circular pipelines of a
``PipelineMLP`` are :mod:`.pipeline`).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..models.feedforward import Network, unchain
from ..ops import prim as P
from ..ops.ir import Compose, First, GMul, LiftOp, Shuffle, SumOp, TOp
from ..ops.shapes import ShapeError


def network_segments(net: Network) -> List[Tuple[TOp, Tuple[Any, ...]]]:
    """The network's layer sub-graphs paired with their parameter slices
    (in stack order)."""
    segs = unchain(net.op)
    out = []
    cursor = 0
    for seg in segs:
        k = len(seg.in_stack) - 1
        out.append((seg, tuple(net.params[cursor:cursor + k])))
        cursor += k
    if cursor != len(net.params):
        raise ShapeError(
            f"unchain consumed {cursor} params but network has "
            f"{len(net.params)}")
    return out


def _flat(op: TOp) -> list:
    """The chain of a segment's ``>>`` compositions, in order."""
    return (_flat(op.f) + _flat(op.g)) if isinstance(op, Compose) else [op]


def _tp_local_segment_split(op: TOp, tp: int
                            ) -> Optional[Tuple[TOp, Optional[TOp]]]:
    """Row-parallel (Megatron) split of an ffLayer segment: if ``op``
    matches the gen_net layer pattern
    ``First(swap >> matVec, rest=[(o,)]) >> add >> [tail...]`` and ``tp``
    divides ``o``, return ``(local, suffix)``: ``local`` is the affine part
    plus the maximal rowwise (elementwise) prefix of the tail rebuilt at
    width ``o/tp`` (weights and bias row-sharded over the model axis), and
    ``suffix`` is the remaining non-rowwise tail (e.g. the softmax
    normalization ``duplicate >> first(sumRows >> recip) >> outer``,
    ``NeuralNet.hs:52-59``) recomposed at FULL width, to run replicated
    after the activation all-gather: the standard sharded-softmax
    decomposition (local exp rows, global sum after the gather).
    ``suffix`` is None for all-elementwise tails.  Returns None when the
    segment does not match (the caller falls back, loudly)."""
    nodes = _flat(op)
    if len(nodes) < 2 or not isinstance(nodes[0], First):
        return None
    inner = _flat(nodes[0].op)
    if len(inner) != 2:
        return None
    sw, gm = inner
    if not (isinstance(sw, Shuffle) and sw.idxs == (1, 0)):
        return None
    if not (isinstance(gm, GMul) and len(gm.ms) == 1 and len(gm.os) == 1
            and not gm.ns):
        return None
    o, i = gm.ms[0], gm.os[0]
    if o % tp != 0 or nodes[0].rest != ((o,),):
        return None
    if not (isinstance(nodes[1], SumOp) and nodes[1].n == 2
            and nodes[1].shape == (o,)):
        return None
    k = 2
    while (k < len(nodes) and isinstance(nodes[k], LiftOp)
           and nodes[k].shape == (o,) and nodes[k].vf.n_args == 1):
        k += 1
    suffix: Optional[TOp] = None
    if k < len(nodes):
        suffix = nodes[k]
        for nd in nodes[k + 1:]:
            suffix = suffix >> nd
        if (suffix.in_stack != ((o,),) or len(suffix.out_stack) != 1
                or len(suffix.out_stack[0]) != 1):
            return None
    o_l = o // tp
    local = P.first(P.swap((i,), (o_l, i)) >> P.mat_vec(o_l, i),
                    rest=[(o_l,)]) >> SumOp(2, (o_l,))
    for nd in nodes[2:k]:
        local = local >> LiftOp(nd.vf, (o_l,))
    return local, suffix


def _tp_local_segment(op: TOp, tp: int) -> Optional[TOp]:
    """The suffix-free case of :func:`_tp_local_segment_split`: the
    uniform-body tp path, where every stage evaluates the same stacked
    segment and no replicated tail is plumbed."""
    r = _tp_local_segment_split(op, tp)
    if r is None or r[1] is not None:
        return None
    return r[0]
