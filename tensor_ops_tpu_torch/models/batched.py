"""Batched lowering: rebuild a per-sample ``gen_net`` graph as a BATCHED
staged-IR graph whose loss is the batch mean, the batch a tensor
dimension inside the IR instead of ``torch.func.vmap`` outside it (the
JAX package's ``models/batched.py``).

``vmap(per-sample transposition)`` + ``mean`` writes the weight gradients
as B stacked per-sample outer products and then sums them.  Lowering the
batch into the graph makes each weight gradient one contraction over the
batch axis by construction: the batched ``GMul``'s own transposition
(``dy = gmul(transp(x), dz)``) is one GEMM.  The bf16 step of
``trainer.make_opt_step`` takes this graph; the per-sample graph stays the
semantic reference.

Supported graphs: ``gen_net``-style chains, segments of the ffLayer
pattern ``First(swap >> matVec, rest=[(o,)]) >> add`` followed by any
parameterless single-chain tail (elementwise ``LiftOp``s widen to the
batched shape; anything else, e.g. softmax's sumRows/outer internals, is
wrapped in :class:`~tensor_ops_tpu_torch.ops.loops.MappedOp`, which is
safe because tails carry no parameters).  ``batched_loss_graph`` returns
None for graphs outside this family; callers fall back to the vmapped
per-sample path.
"""

from __future__ import annotations

from typing import List, Optional

from ..ops import prim as P
from ..ops.ir import (BroadcastRows, Compose, First, GMul, LiftOp, Second,
                      Shuffle, SumOp, TOp, Transp)
from ..ops.loops import MappedOp


def _flatten(op: TOp) -> List[TOp]:
    if isinstance(op, Compose):
        return _flatten(op.f) + _flatten(op.g)
    return [op]


def _batched_linear(B: int, i: int, o: int) -> TOp:
    """[(B,i) x, (o,i) w, (o,) b] -> [(B,o)]: one batched contraction and
    a broadcast bias, whose transposes are the GEMM weight gradient
    (contracted over B) and the bias row-sum."""
    return (
        Second(First(Transp((o, i)), rest=[(o,)]), front=[(B, i)])
        >> First(GMul((B,), (i,), (o,)), rest=[(o,)])
        >> Second(BroadcastRows((o,), B), front=[(B, o)])
        >> SumOp(2, (B, o))
    )


def _batch_tail_node(nd: TOp, B: int) -> Optional[TOp]:
    """Batch a parameterless tail node: an elementwise ``LiftOp`` widens
    to the batched shape; anything else is mapped over the rows by
    ``MappedOp`` (no parameter flows through a tail, so no per-sample
    parameter gradient is written)."""
    if isinstance(nd, LiftOp) and nd.vf.n_args == 1:
        return LiftOp(nd.vf, (B,) + nd.shape)
    for sh in nd.in_stack + nd.out_stack:
        if len(sh) != 1 and sh != ():
            return None
    return MappedOp(nd, B)


def _batch_segment(seg: TOp, B: int) -> Optional[TOp]:
    nodes = _flatten(seg)
    if len(nodes) >= 2 and isinstance(nodes[0], First):
        inner = _flatten(nodes[0].op)
        if (
            len(inner) == 2
            and isinstance(inner[0], Shuffle)
            and inner[0].idxs == (1, 0)
            and isinstance(inner[1], GMul)
            and len(inner[1].ms) == 1
            and len(inner[1].os) == 1
            and not inner[1].ns
        ):
            o, i = inner[1].ms[0], inner[1].os[0]
            if (
                nodes[0].rest == ((o,),)
                and isinstance(nodes[1], SumOp)
                and nodes[1].n == 2
                and nodes[1].shape == (o,)
            ):
                op = _batched_linear(B, i, o)
                for nd in nodes[2:]:
                    b = _batch_tail_node(nd, B)
                    if b is None:
                        return None
                    op = op >> b
                return op
    # a parameterless segment (e.g. a lifted activation net): map it whole
    if len(seg.in_stack) == 1:
        ok = all(len(sh) <= 1 for sh in seg.in_stack + seg.out_stack)
        return MappedOp(seg, B) if ok else None
    return None


def batch_network_op(net_op: TOp, B: int) -> Optional[TOp]:
    """The batched network graph ``([x (B,i)] + params) -> [(B,o)]`` with
    UNBATCHED parameter slots, or None when the graph falls outside the
    supported family."""
    from .feedforward import unchain

    cur = None
    for seg in unchain(net_op):
        bseg = _batch_segment(seg, B)
        if bseg is None:
            return None
        cur = (bseg if cur is None
               else First(cur, rest=seg.in_stack[1:]) >> bseg)
    return cur


def batched_loss_graph(net, loss: TOp, B: int) -> Optional[TOp]:
    """``([x (B,i)] + params + [targets (B,o)]) -> scalar``, the batch-MEAN
    loss over the batched network graph: the gradients of the parameter
    slots come out of ONE transposition as contractions over the batch
    axis.  Cached per (loss, B) on the network op, a negative result too.
    None when the network graph is not batchable."""
    key = ("batched_loss", loss.struct_key(), B)
    g = net.op._compiled.get(key)
    if g is not None:
        return g if g is not False else None
    bop = batch_network_op(net.op, B)
    if bop is None:
        net.op._compiled[key] = False
        return None
    tgt = (B,) + net.out_shape
    g = (
        First(bop, rest=[tgt])
        >> MappedOp(loss, B)
        >> P.sum_rows((B,))
        >> P.scale((), 1.0 / B)
    )
    net.op._compiled[key] = g
    return g
