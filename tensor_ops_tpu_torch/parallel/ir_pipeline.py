"""Pipeline parallelism over the staged IR itself: the counterpart of
``tensor_ops_tpu/parallel/ir_pipeline.py`` on a mesh with a ``stage`` axis,
and with a ``model`` axis beside it (the ``(data, stage, model)`` mesh).

A ``Network`` built with ``then`` / ``gen_net`` is a chain of layer
sub-graphs (:func:`network_segments`).  A partition cuts that chain over
the stage axis: the uniform cut (:func:`split_network`) stacks a run of
identical segments, the heterogeneous cut (:func:`split_network_hetero`)
packs FLOP-balanced groups of any segments into one ``(S, Lmax)`` leaf, and
their circular forms (:func:`split_network_circular`,
:func:`split_network_hetero_circular`) store the chunks in the interleaved
order of the circular schedule.  On a model axis of tp > 1 every segment
that matches the ffLayer pattern is also row-split over the model ranks
(:func:`_tp_local_segment_split`): the uniform body's stacks split their
row dimension over the model axis (:func:`pipeline_tp_segment`), and the
heterogeneous cuts pack each model rank's row slices
(:func:`split_network_hetero_tp`, ``(S, tp, Lmax)``;
:func:`split_network_hetero_tp_circular`, ``(S, V, tp, Lmax)``).  The
layouts are the JAX package's leaf for leaf, so a ``.state`` file of either
package resumes in the other.

Every stage evaluates its segments' own staged sub-graphs, and their
backward is the IR's transposition (``op.transpose``): ``torch.autograd``
orchestrates the schedule, never the inside of a segment.  A batched
segment (:func:`batched_ir_call`) runs ``op.apply`` mapped over the batch
and, in its backward, the mapped VJP ``ir.vjp``, which recomputes the
segment's forward with ``apply_tape`` before ``op.transpose`` (the route of
:mod:`.tp`'s executor); :func:`ir_call` keeps the tape of one unbatched
call instead.

The schedule is :mod:`.pipeline`'s eager one (``_schedule``: masked ticks
skipped, the circular schedule's FIFO), the closing ``lax.psum`` over the
stage axis kernel 9's all-reduce (``_StageSum``).  Each data group runs its
rows of every microbatch (the JAX package's ``PSpec(None, DATA_AXIS,
None)``); a uniform partition's replicated ``pre`` and ``post`` segments
and the loss run once per data group, on its stage-0 rank, and each
replicated leaf's gradient is summed over the group's stage ranks by
kernel 9.  The ring carries each stage boundary at its own width (an eager
hand-off has no fixed shape; the JAX package pads to the widest boundary
for ``lax.switch``, which changes no value).

With the model axis, each model rank of a stage runs its row block of each
segment on the whole activation, and kernel 9's all-gather over the model
group (``pipeline._FeatureGather``) restores the whole activation between
segments; a segment's non-rowwise tail (the softmax normalization) then
runs whole on every model rank.  The gather's transpose reduce-scatters
the cotangents each model rank holds as its share of the sum, so the
stage psum, the ``post`` segments and the loss run on the home column
alone (model rank 0): every cotangent enters the model group once.  A
partition that cannot row-split leaves the model axis idle, as the JAX
package does, with its warning: model rank 0 of each stage runs it, and
the gradients of its leaves are summed over the model group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..models.feedforward import Network, unchain
from ..ops import ir
from ..ops import prim as P
from ..ops.ir import Compose, First, GMul, LiftOp, Shuffle, SumOp, TOp
from ..ops.shapes import ShapeError
from .collective_kernels import ring_all_reduce_bidir
from .mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, Sharded,
                   _all_gather, _split_rows, place, reduce_mean)
from .pipeline import (_FeatureGather, _Layout, _StageSum, _group_op,
                       _schedule, _sum16)


# ---------------------------------------------------------------------------
# unchaining a Network op at its composition points
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the framework-AD seam: torch.autograd around a staged sub-graph
# ---------------------------------------------------------------------------


class _IRCall(torch.autograd.Function):
    """``op`` on one sample: the forward runs ``op.apply_tape`` and keeps
    the tape, the backward returns ``op.transpose`` of the cotangents."""

    @staticmethod
    def forward(ctx, op, be, *xs):
        ys, tape = op.apply_tape(be, xs, with_tape=True)
        ctx.op, ctx.be, ctx.tape = op, be, tape
        return tuple(ys)

    @staticmethod
    def backward(ctx, *cts):
        return (None, None) + tuple(ctx.op.transpose(ctx.be, ctx.tape, cts))


def ir_call(op: TOp, be) -> Callable:
    """``fn(*xs) -> ys tuple`` evaluating ``op`` with gradients supplied by
    the op's OWN transposition rule: the forward tapes residuals through
    ``apply_tape`` and the backward runs ``op.transpose``; autograd never
    sees inside the sub-graph."""

    def call(*xs):
        return _IRCall.apply(op, be, *xs)

    return call


class _BatchedIR(torch.autograd.Function):
    """A segment mapped over a leading batch axis: ``fwd`` is the vmapped
    ``op.apply``, ``bwd`` the vmapped ``ir.vjp`` (the forward's tape
    recomputed, then ``op.transpose``); the broadcast parameters'
    per-sample cotangents are summed over the batch."""

    @staticmethod
    def forward(ctx, fwd, bwd, n_batched, *xs):
        ctx.save_for_backward(*xs)
        ctx.bwd, ctx.n_batched = bwd, n_batched
        return fwd(*xs)

    @staticmethod
    def backward(ctx, ct):
        xs = ctx.saved_tensors
        cts = ctx.bwd(*xs, ct.contiguous())
        nb = ctx.n_batched
        return (None, None, None) + tuple(cts[:nb]) + tuple(
            c.sum(dim=0) for c in cts[nb:])


def batched_ir_call(op: TOp, be, n_batched: int = 1) -> Callable:
    """``fn(*batched, *params) -> yb``: the per-sample sub-graph (one output)
    mapped over the leading batch axis of its first ``n_batched`` inputs,
    the params broadcast; gradients from ``op.transpose`` (the vmapped VJP
    recomputes the forward, see :class:`_BatchedIR`)."""
    n_params = len(op.in_stack) - n_batched
    dims = (0,) * n_batched + (None,) * n_params
    fwd = torch.func.vmap(lambda *a: op.apply(be, a)[0], in_dims=dims)
    bwd = torch.func.vmap(lambda *a: ir.vjp(op, be, a[:-1], (a[-1],)),
                          in_dims=dims + (0,))

    def call(*xs):
        return _BatchedIR.apply(fwd, bwd, n_batched, *xs)

    return call


# ---------------------------------------------------------------------------
# leaves: tensors, arrays, or Sharded leaves on a stage mesh
# ---------------------------------------------------------------------------


def _stack(xs):
    return (torch.stack(list(xs)) if isinstance(xs[0], torch.Tensor)
            else np.stack([np.asarray(x) for x in xs]))


def _ravel(x):
    return x.reshape(-1) if isinstance(x, torch.Tensor) else np.ravel(x)


def _concat_rows(flat, like):
    """One flat row of ``flat`` (an empty one of ``like``'s dtype)."""
    if isinstance(like, torch.Tensor):
        return (torch.cat(flat) if flat else
                torch.zeros((0,), dtype=like.dtype, device=like.device))
    return (np.concatenate(flat) if flat
            else np.zeros((0,), np.asarray(like).dtype))


def _pad_stack(rows, lmax: int):
    """The rows zero-padded to ``lmax`` and stacked."""
    if isinstance(rows[0], torch.Tensor):
        return torch.stack([torch.nn.functional.pad(r, (0, lmax - r.shape[0]))
                            for r in rows])
    return np.stack([np.pad(r, (0, lmax - r.shape[0])) for r in rows])


def _row(leaf, j: int, *rest: int):
    """Row ``j`` of ``leaf``'s leading (stage-split) axis, indexed further
    by ``rest``: on a :class:`Sharded` leaf, the view in the shard of the
    stage rank that holds it (data rank 0), on that rank's device; where
    the leaf's spec splits a later dimension over the model axis, the
    model ranks' blocks of it copied there and joined (no collective)."""
    if not isinstance(leaf, Sharded):
        for i in (j,) + rest:
            leaf = leaf[i]
        return leaf
    per = leaf.shards[0].shape[0]
    s, k = divmod(j, per)
    ranks = [int(r) for r in _Layout(leaf.mesh).rank[0, s]]
    blocks = []
    for r in ranks:
        x = leaf.shards[r][k]
        for i in rest:
            x = x[i]
        blocks.append(x)
    md = leaf.mdim
    if md is None:
        return blocks[0]
    dev = blocks[0].device
    return torch.cat([b.to(dev) for b in blocks], dim=md - 1 - len(rest))


def _home(leaf):
    """A replicated leaf: rank 0's copy of a :class:`Sharded` one."""
    return leaf.shards[0] if isinstance(leaf, Sharded) else leaf


def _numel(sh) -> int:
    return int(np.prod(sh, dtype=np.int64)) if sh else 1


def _unpack(row, ops) -> list:
    """A flat parameter row split into the params of ``ops`` in order."""
    ps, ofs = [], 0
    for op in ops:
        for sh in op.in_stack[1:]:
            k = _numel(sh)
            ps.append(row[ofs:ofs + k].reshape(sh))
            ofs += k
    return ps


def _unpack_tp(rows, ops, tp: int) -> list:
    """The params of the full-width ``ops`` from the ``tp`` model ranks'
    rows (``rows[m]`` rank m's row slices of every param, flat): each
    param's slices joined along its row dimension."""
    ps, ofs = [], 0
    for op in ops:
        for sh in op.in_stack[1:]:
            loc = (sh[0] // tp,) + tuple(sh[1:])
            k = _numel(loc)
            parts = [rows[m][ofs:ofs + k].reshape(loc) for m in range(tp)]
            ps.append(torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                      else np.concatenate(parts))
            ofs += k
    return ps


# ---------------------------------------------------------------------------
# stage partitioning
# ---------------------------------------------------------------------------


@dataclass
class PipelinedNetwork:
    """A Network split for pipelining: replicated ``pre`` segments, a
    uniform ``body`` (one op evaluated with per-stage stacked params),
    replicated ``post`` segments."""

    pre: List[Tuple[TOp, Tuple[Any, ...]]]
    body_op: Optional[TOp]
    body_params: Tuple[Any, ...]  # each (n_body, *param_shape)
    n_body: int
    post: List[Tuple[TOp, Tuple[Any, ...]]]

    def flat_params(self) -> Tuple[Any, ...]:
        ps: List[Any] = []
        for _, p in self.pre:
            ps.extend(p)
        ps.extend(self.body_params)
        for _, p in self.post:
            ps.extend(p)
        return tuple(ps)

    def unflatten(self, flat: Tuple[Any, ...]) -> "PipelinedNetwork":
        it = iter(flat)
        pre = [(op, tuple(next(it) for _ in p)) for op, p in self.pre]
        body = tuple(next(it) for _ in self.body_params)
        post = [(op, tuple(next(it) for _ in p)) for op, p in self.post]
        return PipelinedNetwork(pre, self.body_op, body, self.n_body, post)

    def skeleton(self) -> "PipelinedNetwork":
        """Structure-only copy (param arrays replaced by None): safe to
        capture in long-lived closures and caches without pinning a
        parameter copy; ``unflatten`` / ``flat_params`` only count."""
        return PipelinedNetwork(
            [(op, tuple(None for _ in p)) for op, p in self.pre],
            self.body_op,
            tuple(None for _ in self.body_params),
            self.n_body,
            [(op, tuple(None for _ in p)) for op, p in self.post])

    def _stored(self, k: int) -> int:
        """The stored row of logical body segment ``k``."""
        return k

    def to_network_params(self) -> Tuple[Any, ...]:
        """Back to the original Network param stack (body unstacked in
        segment order); on placed leaves each segment's params stay on the
        device of the stage that holds them."""
        ps: List[Any] = []
        for _, p in self.pre:
            ps.extend(_home(x) for x in p)
        for k in range(self.n_body):
            j = self._stored(k)
            ps.extend(_row(b, j) for b in self.body_params)
        for _, p in self.post:
            ps.extend(_home(x) for x in p)
        return tuple(ps)


def _op_flops(op: TOp) -> float:
    """Crude FLOP estimate of a sub-graph, enough to balance stage cuts.
    Contractions dominate (2*|ms|*|os|*|ns| per GMul); structure nodes
    recurse; everything else counts its output elements."""
    from ..ops.ir import Fanout, Par, Second

    if isinstance(op, GMul):
        return 2.0 * float(np.prod(op.ms + op.os + op.ns, dtype=np.float64))
    if isinstance(op, Compose):
        return _op_flops(op.f) + _op_flops(op.g)
    if isinstance(op, (Par, Fanout)):
        return _op_flops(op.f) + _op_flops(op.g)
    if isinstance(op, (First, Second)):
        return _op_flops(op.op)
    inner = getattr(op, "op", None) or getattr(op, "step", None)
    if isinstance(inner, TOp):  # MappedOp/Remat (.op) and ScanOp (.step)
        return float(getattr(op, "n", 1)) * _op_flops(inner)
    return float(sum(np.prod(s, dtype=np.float64) if s else 1.0
                     for s in op.out_stack))


def _balanced_partition(costs, n_groups: int):
    """Contiguous partition of ``costs`` into ``n_groups`` non-empty groups
    minimizing the maximum group cost (DP, exact).  Returns ``[(start,
    end), ...]`` index bounds."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(n_groups + 1)]
    cut = [[0] * (n + 1) for _ in range(n_groups + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_groups + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(dp[s - 1][j], prefix[i] - prefix[j])
                if v < dp[s][i]:
                    dp[s][i], cut[s][i] = v, j
    bounds = []
    i = n
    for s in range(n_groups, 0, -1):
        j = cut[s][i]
        bounds.append((j, i))
        i = j
    return list(reversed(bounds))


@dataclass
class HeteroPipelinedNetwork:
    """A Network cut into S contiguous, FLOP-balanced stage groups of
    (possibly structurally distinct) segments: the general partition that
    pipelines the flagship 784->300->100->10 chain, not just uniform-width
    bodies.  Ragged per-stage parameters pack into one ``(S, Lmax)`` leaf
    of flattened-and-padded rows (split over the stage axis); each stage
    rank runs its own segments on its row."""

    stage_ops: List[List[TOp]]      # S stages of segment sub-ops
    packed: Optional[Any]           # (S, Lmax) padded flat param rows
    width: int                      # the widest stage boundary H
    lmax: int

    @property
    def n_stages(self) -> int:
        return len(self.stage_ops)

    @property
    def in_width(self) -> int:
        return self.stage_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.stage_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat: Tuple[Any, ...]) -> "HeteroPipelinedNetwork":
        (packed,) = flat
        return HeteroPipelinedNetwork(self.stage_ops, packed, self.width,
                                      self.lmax)

    def skeleton(self) -> "HeteroPipelinedNetwork":
        return HeteroPipelinedNetwork(self.stage_ops, None, self.width,
                                      self.lmax)

    def to_network_params(self) -> Tuple[Any, ...]:
        """Back to the original Network param stack (each stage row
        unpacked into its segments' shapes, in chain order)."""
        ps: List[Any] = []
        for s, ops in enumerate(self.stage_ops):
            ps.extend(_unpack(_row(self.packed, s), ops))
        return tuple(ps)


def _hetero_groups(net: Network, n_groups: int
                   ) -> Tuple[List[List[TOp]], List[Any], int]:
    """Cut the ``then``-chain into ``n_groups`` contiguous FLOP-balanced
    groups: ``(group_ops, flat_param_rows, ring_width)``, the shared core
    of the heterogeneous GPipe and circular partitions."""
    segs = network_segments(net)
    if len(segs) < n_groups:
        raise ShapeError(
            f"pipeline needs >= {n_groups} composition segments, the "
            f"network has {len(segs)}")
    widths = set()
    for op, _ in segs:
        for sh in (op.in_stack[0], op.out_stack[0]):
            if len(sh) != 1:
                raise ShapeError(
                    f"hetero pipeline stages exchange rank-1 activations; "
                    f"segment boundary has shape {sh}")
            widths.add(sh[0])
    H = max(widths)
    bounds = _balanced_partition([_op_flops(op) for op, _ in segs],
                                 n_groups)
    like = net.params[0] if net.params else np.zeros((0,), np.float32)
    group_ops: List[List[TOp]] = []
    rows = []
    for a, b in bounds:
        group_ops.append([op for op, _ in segs[a:b]])
        rows.append(_concat_rows([_ravel(p) for _, ps in segs[a:b]
                                  for p in ps], like))
    return group_ops, rows, H


def split_network_hetero(net: Network, n_stages: int
                         ) -> HeteroPipelinedNetwork:
    """Cut ANY ``then``-chain into ``n_stages`` contiguous stage groups
    (FLOP-balanced by exact min-max DP): the generalization of
    :func:`split_network` beyond uniform bodies."""
    stage_ops, rows, H = _hetero_groups(net, n_stages)
    lmax = max(int(r.shape[0]) for r in rows)
    return HeteroPipelinedNetwork(stage_ops, _pad_stack(rows, lmax), H, lmax)


def split_network(net: Network, n_stages: int) -> PipelinedNetwork:
    """Cut the network at its composition points: find the maximal run of
    structurally identical segments (the uniform ffLayer body), require its
    length divisible by ``n_stages``, and stack its params with a leading
    segment axis; segments before and after run replicated."""
    segs = network_segments(net)
    keys = [op.struct_key() for op, _ in segs]
    best_start, best_len = 0, 1
    start = 0
    for i in range(1, len(keys) + 1):
        if i == len(keys) or keys[i] != keys[start]:
            if i - start > best_len:
                best_start, best_len = start, i - start
            start = i
    n_body = (best_len // n_stages) * n_stages
    if n_body < n_stages:
        raise ShapeError(
            f"pipeline needs >= {n_stages} structurally identical layer "
            f"segments; longest uniform run is {best_len} "
            f"(segments: {[tuple(op.in_stack) for op, _ in segs]})")
    body = segs[best_start:best_start + n_body]
    body_params = tuple(_stack([seg_params[j] for _, seg_params in body])
                        for j in range(len(body[0][1])))
    return PipelinedNetwork(pre=segs[:best_start], body_op=body[0][0],
                            body_params=body_params, n_body=n_body,
                            post=segs[best_start + n_body:])


@dataclass
class HeteroTpPipelinedNetwork:
    """A heterogeneous partition that also tensor-parallels: every segment
    matches the row-shardable ffLayer pattern (elementwise tails, and
    softmax tails whose normalization runs whole after the all-gather), so
    each stage's params pack as ``(S, tp, Lmax)`` rows of per-model-rank
    row slices, split over both the stage and the model axes.  Each rank
    runs its stage's row-local segments (:func:`_tp_local_segment_split`)
    with an activation all-gather between segments."""

    stage_ops: List[List[TOp]]        # full-width segment ops per stage
    local_ops: List[List[Tuple[TOp, Optional[TOp]]]]  # (row-local, suffix)
    packed: Optional[Any]             # (S, tp, Lmax)
    width: int                        # the widest stage boundary H
    lmax: int
    tp: int

    @property
    def n_stages(self) -> int:
        return len(self.stage_ops)

    @property
    def in_width(self) -> int:
        return self.stage_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.stage_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat) -> "HeteroTpPipelinedNetwork":
        (packed,) = flat
        return HeteroTpPipelinedNetwork(self.stage_ops, self.local_ops,
                                        packed, self.width, self.lmax,
                                        self.tp)

    def skeleton(self) -> "HeteroTpPipelinedNetwork":
        return HeteroTpPipelinedNetwork(self.stage_ops, self.local_ops,
                                        None, self.width, self.lmax, self.tp)

    def to_network_params(self) -> Tuple[Any, ...]:
        """The Network stack: each param's tp row slices joined back to
        full width, in chain order (on placed leaves, on the device of the
        stage's first rank)."""
        ps: List[Any] = []
        for s, ops in enumerate(self.stage_ops):
            ps.extend(_unpack_tp(_row(self.packed, s), ops, self.tp))
        return tuple(ps)


def _hetero_tp_groups(net: Network, n_groups: int, tp: int):
    """The shared core of the tensor-parallel heterogeneous cuts (GPipe
    stages and circular chunk groups): the ``then``-chain cut into
    ``n_groups`` contiguous FLOP-balanced groups with every segment
    row-split over ``tp``: ``(group_ops, local_ops, per_rank_rows,
    ring_width)``, or None when a segment does not match the ffLayer
    pattern or its width does not divide by ``tp`` (the caller falls back,
    loudly)."""
    segs = network_segments(net)
    if len(segs) < n_groups:
        return None
    local = [_tp_local_segment_split(op, tp) for op, _ in segs]
    if any(lo is None for lo in local):
        return None
    widths = set()
    for op, _ in segs:
        for sh in (op.in_stack[0], op.out_stack[0]):
            if len(sh) != 1:
                return None
            widths.add(sh[0])
    H = max(widths)
    bounds = _balanced_partition([_op_flops(op) for op, _ in segs],
                                 n_groups)
    like = net.params[0]
    group_ops, local_ops, rows = [], [], []
    for a, b in bounds:
        group_ops.append([op for op, _ in segs[a:b]])
        local_ops.append(local[a:b])
        per_rank = []
        for m in range(tp):
            flat = []
            for op, ps in segs[a:b]:
                for sh, p in zip(op.in_stack[1:], ps):
                    o_l = sh[0] // tp
                    flat.append(_ravel(p[m * o_l:(m + 1) * o_l]))
            per_rank.append(_concat_rows(flat, like))
        rows.append(per_rank)
    return group_ops, local_ops, rows, H


def split_network_hetero_tp(net: Network, n_stages: int, tp: int
                            ) -> Optional[HeteroTpPipelinedNetwork]:
    """The heterogeneous FLOP-balanced cut with every segment row-split
    over ``tp`` model ranks: possible only when every segment matches the
    ffLayer pattern with a tp-divisible output width (else None; the
    caller falls back to the model-replicated heterogeneous cut).
    Softmax-tailed segments split too: the affine rows and the exp run
    row-local, the normalization whole after the all-gather."""
    r = _hetero_tp_groups(net, n_stages, tp)
    if r is None:
        return None
    stage_ops, local_ops, rows, H = r
    lmax = max(int(x.shape[0]) for sh in rows for x in sh)
    packed = _stack([_pad_stack(sh, lmax) for sh in rows])
    return HeteroTpPipelinedNetwork(stage_ops, local_ops, packed, H, lmax,
                                    tp)


# ---------------------------------------------------------------------------
# circular (interleaved) partitions
# ---------------------------------------------------------------------------


def _interleave_perm(n_body: int, S: int, V: int) -> np.ndarray:
    """Segment permutation for the circular schedule: global chunk ``c =
    v*S + d`` (``Lc`` consecutive segments) lands at device ``d``'s local
    chunk ``v``, stored device-major so a plain stage-axis split hands each
    device its V chunks contiguously."""
    Lc = n_body // (S * V)
    idx = []
    for d in range(S):
        for v in range(V):
            c = v * S + d
            idx.extend(range(c * Lc, (c + 1) * Lc))
    return np.asarray(idx)


@dataclass
class CircularPipelinedNetwork(PipelinedNetwork):
    """A uniform-body partition stored in circular-schedule order: the body
    stacks are segment-permuted (:func:`_interleave_perm`) so the stage
    split gives device ``d`` chunks ``d, S+d, 2S+d, ...``.
    ``to_network_params`` undoes the permutation, so checkpoints stay
    ordinary Network stacks."""

    n_stages: int = 0
    n_chunks: int = 0  # V

    def _stored(self, k: int) -> int:
        perm = _interleave_perm(self.n_body, self.n_stages, self.n_chunks)
        return int(np.argsort(perm)[k])

    def unflatten(self, flat: Tuple[Any, ...]) -> "CircularPipelinedNetwork":
        p = super().unflatten(flat)
        return CircularPipelinedNetwork(
            p.pre, p.body_op, p.body_params, p.n_body, p.post,
            n_stages=self.n_stages, n_chunks=self.n_chunks)

    def skeleton(self) -> "CircularPipelinedNetwork":
        p = super().skeleton()
        return CircularPipelinedNetwork(
            p.pre, p.body_op, p.body_params, p.n_body, p.post,
            n_stages=self.n_stages, n_chunks=self.n_chunks)


def _check_chunks(n_chunks: int) -> None:
    if n_chunks < 1:
        raise ShapeError(
            f"circular schedule needs n_chunks >= 1, got {n_chunks}")


def split_network_circular(net: Network, n_stages: int, n_chunks: int
                           ) -> CircularPipelinedNetwork:
    """The uniform split with the body stored in circular order: the
    longest uniform run must hold S*V chunk-rows (each device runs V
    round-robin chunks of Lc = n_body/(S*V) segments)."""
    _check_chunks(n_chunks)
    p = split_network(net, n_stages * n_chunks)
    perm = _interleave_perm(p.n_body, n_stages, n_chunks)
    if isinstance(p.body_params[0], torch.Tensor):
        perm = torch.as_tensor(perm, device=p.body_params[0].device)
    return CircularPipelinedNetwork(
        p.pre, p.body_op, tuple(b[perm] for b in p.body_params),
        p.n_body, p.post, n_stages=n_stages, n_chunks=n_chunks)


@dataclass
class HeteroCircularPipelinedNetwork:
    """A heterogeneous partition in circular-schedule order: the whole
    ``then``-chain cut into ``S*V`` contiguous FLOP-balanced chunk groups;
    device ``d`` runs chunks ``d, S+d, ..., (V-1)S+d`` round-robin, for
    chains the uniform split rejects (e.g. autoencoder pyramids).

    Packed rows ``(S, V, Lmax)``: ``[d, v]`` holds chunk ``v*S + d``'s
    flattened-and-padded params, so a plain stage-axis split hands each
    device its V chunk rows.  ``to_network_params`` walks chunks in chain
    order, so checkpoints stay ordinary Network stacks."""

    chunk_ops: List[List[TOp]]      # S*V chunk groups, chain order
    packed: Optional[Any]           # (S, V, Lmax)
    width: int                      # the widest stage boundary H
    lmax: int
    S: int
    V: int

    @property
    def n_stages(self) -> int:
        return self.S

    @property
    def n_chunks(self) -> int:
        return self.V

    @property
    def in_width(self) -> int:
        return self.chunk_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.chunk_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat: Tuple[Any, ...]
                  ) -> "HeteroCircularPipelinedNetwork":
        (packed,) = flat
        return HeteroCircularPipelinedNetwork(
            self.chunk_ops, packed, self.width, self.lmax, self.S, self.V)

    def skeleton(self) -> "HeteroCircularPipelinedNetwork":
        return HeteroCircularPipelinedNetwork(
            self.chunk_ops, None, self.width, self.lmax, self.S, self.V)

    def to_network_params(self) -> Tuple[Any, ...]:
        ps: List[Any] = []
        for c, ops in enumerate(self.chunk_ops):
            ps.extend(_unpack(_row(self.packed, c % self.S)[c // self.S],
                              ops))
        return tuple(ps)


def split_network_hetero_circular(net: Network, n_stages: int,
                                  n_chunks: int
                                  ) -> HeteroCircularPipelinedNetwork:
    """The heterogeneous FLOP-balanced cut stored in circular order:
    ``S*V`` chunk groups packed as ``(S, V, Lmax)`` rows (``[d, v]`` =
    chunk ``v*S + d``), the interleaved schedule for chains
    :func:`split_network_circular`'s uniform-run requirement rejects."""
    _check_chunks(n_chunks)
    S, V = n_stages, n_chunks
    group_ops, rows, H = _hetero_groups(net, S * V)
    lmax = max(int(r.shape[0]) for r in rows)
    padded = _pad_stack(rows, lmax)
    packed = _stack([_stack([padded[v * S + d] for v in range(V)])
                     for d in range(S)])
    return HeteroCircularPipelinedNetwork(group_ops, packed, H, lmax, S, V)


@dataclass
class HeteroTpCircularPipelinedNetwork:
    """A heterogeneous circular partition that also tensor-parallels: the
    ``S*V`` chunk groups of :class:`HeteroCircularPipelinedNetwork` with
    every segment row-split over ``tp`` model ranks.  Packed rows ``(S, V,
    tp, Lmax)``: ``[d, v, m]`` holds chunk ``v*S + d``'s model-rank-``m``
    row slices, so a ``(stage, None, model, None)`` split hands each rank
    its V chunk rows for its model rank.  Softmax-tailed segments run the
    sharded-softmax decomposition."""

    chunk_ops: List[List[TOp]]        # S*V chunk groups, chain order
    local_ops: List[List[Tuple[TOp, Optional[TOp]]]]  # per chunk/segment
    packed: Optional[Any]             # (S, V, tp, Lmax)
    width: int                        # the widest stage boundary H
    lmax: int
    tp: int
    S: int
    V: int

    @property
    def n_stages(self) -> int:
        return self.S

    @property
    def n_chunks(self) -> int:
        return self.V

    @property
    def in_width(self) -> int:
        return self.chunk_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.chunk_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat: Tuple[Any, ...]
                  ) -> "HeteroTpCircularPipelinedNetwork":
        (packed,) = flat
        return HeteroTpCircularPipelinedNetwork(
            self.chunk_ops, self.local_ops, packed, self.width, self.lmax,
            self.tp, self.S, self.V)

    def skeleton(self) -> "HeteroTpCircularPipelinedNetwork":
        return HeteroTpCircularPipelinedNetwork(
            self.chunk_ops, self.local_ops, None, self.width, self.lmax,
            self.tp, self.S, self.V)

    def to_network_params(self) -> Tuple[Any, ...]:
        """The Network stack: chunks in chain order, each param's tp row
        slices joined back to full width."""
        ps: List[Any] = []
        for c, ops in enumerate(self.chunk_ops):
            ps.extend(_unpack_tp(_row(self.packed, c % self.S, c // self.S),
                                 ops, self.tp))
        return tuple(ps)


def split_network_hetero_tp_circular(
        net: Network, n_stages: int, n_chunks: int, tp: int
        ) -> Optional[HeteroTpCircularPipelinedNetwork]:
    """The heterogeneous circular cut with every segment row-split over
    ``tp`` model ranks: ``S*V`` FLOP-balanced chunk groups packed as ``(S,
    V, tp, Lmax)`` rows (``[d, v, m]`` = chunk ``v*S + d``, model rank
    ``m``).  None when a segment does not match the ffLayer pattern or its
    width does not divide by ``tp`` (the caller falls back to the
    model-replicated heterogeneous circular cut, loudly)."""
    _check_chunks(n_chunks)
    S, V = n_stages, n_chunks
    r = _hetero_tp_groups(net, S * V, tp)
    if r is None:
        return None
    group_ops, local_ops, rows, H = r
    lmax = max(int(x.shape[0]) for sh in rows for x in sh)
    padded = [_pad_stack(sh, lmax) for sh in rows]  # S*V of (tp, Lmax)
    packed = _stack([_stack([padded[v * S + d] for v in range(V)])
                     for d in range(S)])            # (S, V, tp, Lmax)
    return HeteroTpCircularPipelinedNetwork(group_ops, local_ops, packed, H,
                                            lmax, tp, S, V)


# ---------------------------------------------------------------------------
# routing and placement
# ---------------------------------------------------------------------------


def _check_mesh(mesh, caller: str) -> int:
    """The stage-axis size of ``mesh``; refuses anything but a
    :class:`Mesh` with a stage axis."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if not isinstance(mesh, Mesh) or STAGE_AXIS not in names:
        raise ValueError(f"{caller}: needs a tensor_ops_tpu_torch Mesh with "
                         f"a stage axis (make_pipeline_mesh), got {mesh!r}")
    return mesh.shape[STAGE_AXIS]


def _model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get(MODEL_AXIS, 1)


def partition_network(net: Network, n_stages: int,
                      mesh: Optional[Mesh] = None):
    """The stage partition ``fit`` / ``make_ir_pipeline_loss`` use: the
    uniform stacked-body cut when the network has one; else, when the mesh
    has a model axis larger than 1 and every segment row-splits over it,
    the tensor-parallel heterogeneous cut; else the model-replicated
    heterogeneous FLOP-balanced cut."""
    try:
        return split_network(net, n_stages)
    except ShapeError:
        pass
    if _model_size(mesh) > 1:
        tp = split_network_hetero_tp(net, n_stages, _model_size(mesh))
        if tp is not None:
            return tp
    return split_network_hetero(net, n_stages)


def partition_network_circular(net: Network, n_stages: int, n_chunks: int,
                               mesh: Optional[Mesh] = None):
    """The circular-schedule partition: the uniform interleaved cut when
    the network has a long-enough uniform run; else, when the mesh has a
    model axis larger than 1 and every segment row-splits over it, the
    tensor-parallel heterogeneous circular cut; else the model-replicated
    heterogeneous FLOP-balanced circular cut (S*V chunk groups), so any
    chain with >= S*V segments runs the interleaved schedule."""
    try:
        return split_network_circular(net, n_stages, n_chunks)
    except ShapeError:
        pass
    if _model_size(mesh) > 1:
        tp = split_network_hetero_tp_circular(net, n_stages, n_chunks,
                                              _model_size(mesh))
        if tp is not None:
            return tp
    return split_network_hetero_circular(net, n_stages, n_chunks)


def pipeline_tp_segment(pnet, mesh: Mesh) -> Optional[TOp]:
    """The row-local body segment when this partition tensor-parallels
    over the mesh's model axis (a uniform body matching the ffLayer pattern
    with a tp-divisible width); None otherwise."""
    if _model_size(mesh) <= 1 or not _uniform(pnet) or pnet.body_op is None:
        return None
    return _tp_local_segment(pnet.body_op, _model_size(mesh))


def pipelined_specs(pnet, mesh: Optional[Mesh] = None
                    ) -> Tuple[Tuple[Optional[str], ...], ...]:
    """One spec per flat leaf (the JAX package's): the body stacks and the
    packed rows over the stage axis on their leading dimension, ``pre`` /
    ``post`` leaves replicated; a tensor-parallel body's stacks also over
    the model axis on their row dimension (when ``mesh`` has a model axis
    the body row-splits over), the tensor-parallel packed rows over the
    model axis on their ``tp`` dimension: ``(stage, model, None)`` and
    ``(stage, None, model, None)``."""
    if isinstance(pnet, HeteroTpPipelinedNetwork):
        return ((STAGE_AXIS, MODEL_AXIS, None),)
    if isinstance(pnet, HeteroTpCircularPipelinedNetwork):
        return ((STAGE_AXIS, None, MODEL_AXIS, None),)
    if isinstance(pnet, (HeteroPipelinedNetwork,
                         HeteroCircularPipelinedNetwork)):
        nd = 3 if isinstance(pnet, HeteroCircularPipelinedNetwork) else 2
        return ((STAGE_AXIS,) + (None,) * (nd - 1),)
    tp = mesh is not None and pipeline_tp_segment(pnet, mesh) is not None
    specs = []
    for op, _ in pnet.pre:
        specs.extend((None,) * len(sh) for sh in op.in_stack[1:])
    specs.extend((STAGE_AXIS,) + ((MODEL_AXIS,) + (None,) * (len(sh) - 1)
                                  if tp else (None,) * len(sh))
                 for sh in pnet.body_op.in_stack[1:])
    for op, _ in pnet.post:
        specs.extend((None,) * len(sh) for sh in op.in_stack[1:])
    return tuple(specs)


def shard_pipelined_params(pnet, mesh: Mesh):
    """The partition with its leaves placed on ``mesh``
    (:class:`~.mesh.Sharded`, :func:`pipelined_specs` on ``mesh``): the body
    stacks or the packed rows over the stage axis (and over the model axis
    where they row-split), ``pre`` / ``post`` replicated."""
    _check_mesh(mesh, "shard_pipelined_params")
    flat = [x if isinstance(x, Sharded) else place(x, s, mesh)
            for x, s in zip(pnet.flat_params(), pipelined_specs(pnet, mesh))]
    return pnet.unflatten(tuple(flat))


# ---------------------------------------------------------------------------
# the pipelined loss
# ---------------------------------------------------------------------------


def _uniform(pnet) -> bool:
    return isinstance(pnet, PipelinedNetwork)


def _tp_partition(pnet) -> bool:
    return isinstance(pnet, (HeteroTpPipelinedNetwork,
                             HeteroTpCircularPipelinedNetwork))


class _PipelinedLoss:
    """The batch-mean loss of a partition on a stage mesh, eagerly in
    autograd (see the module's docstring).  ``group_vag(d)`` is data group
    ``d``'s ``vag(x, y, ps) -> (mean loss, grads)`` of ``fit``'s mesh step
    (``ps`` and the gradients one tuple of the flat leaves per rank of the
    group, concatenated in rank order; the rows ``x`` those of the group's
    part of each microbatch, microbatch by microbatch).  The forward and
    backward run in the backend's dtype: on a bf16 backend the leaves of
    f32 masters are cast for them, and the value and gradients come back
    in the masters' dtype."""

    def __init__(self, pnet, loss: TOp, be, mesh: Mesh, M: int,
                 circular: bool):
        from ..backend.torch_backend import TorchBackend

        self.pnet = pnet.skeleton()
        self.loss, self.mesh, self.M = loss, mesh, M
        self.tp_local = pipeline_tp_segment(self.pnet, mesh)
        # the ranks that run the schedule: every model rank of a stage
        # when the partition row-splits, else model rank 0 of each
        self.lay = _Layout(mesh, home_column=not (
            _tp_partition(pnet) or self.tp_local is not None))
        self.V = pnet.n_chunks if circular else 1
        self.fifo = circular
        self.dtype = be.dtype
        self._bes = {d: TorchBackend(self.dtype, d)
                     for d in dict.fromkeys(mesh.rank_devices)}
        self._calls: dict = {}
        self.specs = pipelined_specs(self.pnet, mesh)
        self.groups = mesh.groups(tuple(a for a in mesh.axis_names
                                        if a != DATA_AXIS))
        # each leaf's gradient is summed over the ranks of its data group
        # that hold the same block: over the stage and model ranks for a
        # replicated leaf, over the model ranks for a stage-split leaf the
        # model axis leaves whole (kernel 9, one call per such set)
        self.sums = []
        for d, group in enumerate(self.groups):
            pos = {r: k for k, r in enumerate(group)}
            per = []
            for i, spec in enumerate(self.specs):
                axes = tuple(a for a in (STAGE_AXIS, MODEL_AXIS)
                             if mesh.shape.get(a, 1) > 1 and a not in spec)
                if axes:
                    per.extend((i, [pos[r] for r in g])
                               for g in mesh.groups(axes) if g[0] in pos)
            self.sums.append(per)

    def _call(self, op: TOp, dev, n_batched: int = 1) -> Callable:
        key = (id(op), dev, n_batched)
        if key not in self._calls:
            self._calls[key] = batched_ir_call(op, self._bes[dev], n_batched)
        return self._calls[key]

    def _segments(self, s: int, v: int):
        """Stage ``s``'s local chunk ``v`` of a packed partition: its
        segments as ``(op, suffix)`` pairs (``op`` row-local on a
        tensor-parallel partition, ``suffix`` the tail it runs whole), and
        the index of its row in a rank's shard of the packed leaf."""
        pnet = self.pnet
        if isinstance(pnet, HeteroTpCircularPipelinedNetwork):
            return pnet.local_ops[v * pnet.S + s], (0, v, 0)
        if isinstance(pnet, HeteroTpPipelinedNetwork):
            return pnet.local_ops[s], (0, 0)
        if isinstance(pnet, HeteroCircularPipelinedNetwork):
            return [(op, None) for op in pnet.chunk_ops[v * pnet.S + s]], \
                (0, v)
        return [(op, None) for op in pnet.stage_ops[s]], (0,)

    def _chunk(self, rs, s: int, v: int, xs, shards):
        """Stage ``s``'s ranks ``rs`` (one per model rank that runs) run
        their local chunk ``v`` on ``xs`` (one input each) with their leaf
        shards; between segments the model group all-gathers the
        activation.  Returns one output per rank."""
        devs = [self.lay.dev(r) for r in rs]
        ps = [shards[r] for r in rs]

        def seg(op, args):
            a = [self._call(op, dev)(x, *p)
                 for x, dev, p in zip(xs, devs, args)]
            return _group_op(_FeatureGather, a)

        if _uniform(self.pnet):
            i0 = sum(len(p) for _, p in self.pnet.pre)
            nb = len(self.pnet.body_params)
            Lc = ps[0][i0].shape[0] // self.V
            op = self.tp_local or self.pnet.body_op
            for k in range(v * Lc, (v + 1) * Lc):
                xs = seg(op, [[p[k] for p in pr[i0:i0 + nb]] for pr in ps])
            return xs
        segs, at = self._segments(s, v)
        args = [_segment_params([op for op, _ in segs], p[0][at])
                for p in ps]
        for k, (op, suffix) in enumerate(segs):
            xs = seg(op, [a[k] for a in args])
            if suffix is not None:
                xs = [self._call(suffix, dev)(x) for x, dev in zip(xs, devs)]
        return xs

    def group_output(self, d: int, shards: dict, x):
        """Data group ``d``'s output rows (microbatch by microbatch) on its
        home rank (stage 0, model 0), ``shards[r]`` rank r's flat
        leaves."""
        lay, pnet, M = self.lay, self.pnet, self.M
        ranks = lay.rank[d]
        home = int(ranks[0][0])
        dev = lay.dev(home)
        h = x.to(dev)
        i = 0
        if _uniform(pnet):
            for op, p in pnet.pre:
                h = self._call(op, dev)(h, *shards[home][i:i + len(p)])
                i += len(p)
        inject = [[part.to(lay.dev(int(r))) for r in ranks[0]]
                  for part in h.reshape((M, -1) + h.shape[1:])]

        def stage(s, v, xs):
            return self._chunk([int(r) for r in ranks[s]], s, v, xs, shards)

        outs = _schedule(lay, d, stage, inject, M, self.V, self.fifo)
        # the stage psum of the home column, whose output the rest reads
        h = _group_op(_StageSum, [outs[s][0] for s in range(lay.S)])[0]
        if _uniform(pnet):
            i = len(self.specs) - sum(len(p) for _, p in pnet.post)
            for op, p in pnet.post:
                h = self._call(op, dev)(h, *shards[home][i:i + len(p)])
                i += len(p)
        return h

    def group_losses(self, d: int, shards: dict, x, y):
        """The per-sample losses of data group ``d``'s rows, on its home
        rank."""
        out = self.group_output(d, shards, x)
        return self._call(self.loss, out.device, 2)(out, y.to(out.device))

    def group_vag(self, d: int) -> Callable:
        group = self.groups[d]
        sums = self.sums[d]
        n = len(self.specs)
        dt = self.dtype

        def vag(x, y, ps):
            leaves = {r: tuple(p.detach().to(dt).requires_grad_()
                               for p in ps[k * n:(k + 1) * n])
                      for k, r in enumerate(group)}
            v = self.group_losses(d, leaves, x.to(dt), y.to(dt)).mean()
            flat = [p for r in group for p in leaves[r]]
            gs = torch.autograd.grad(v, flat, allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, gs)]
            # the masters' dtype, before the gradient sums
            gs = [g.to(p.dtype) for g, p in zip(gs, ps)]
            v = v.to(ps[0].dtype)
            for i, ks in sums:
                for k, g in zip(ks, _sum16([gs[k * n + i] for k in ks])):
                    gs[k * n + i] = g
            return v.detach(), tuple(gs)

        return vag

    def _rows(self, xb, d: int) -> torch.Tensor:
        """Data group ``d``'s rows of a batch (its part of each microbatch)
        on its home rank, in the backend's dtype."""
        dev = self.lay.dev(self.groups[d][0])
        return _split_rows(self._batch(xb), self.lay.dp, d, dev,
                           chunks=self.M).to(self.dtype)

    def _each_group(self, flat, fn) -> list:
        """``fn(d, shards)`` for each data group without autograd,
        ``shards[r]`` rank r's leaves in the backend's dtype."""
        placed = _placed(flat, self.specs, self.mesh)
        with torch.no_grad():
            return [fn(d, {r: tuple(p.shards[r].to(self.dtype)
                                    for p in placed) for r in group})
                    for d, group in enumerate(self.groups)]

    def __call__(self, flat, xb, yb):
        """The batch-mean loss alone (0-d, rank 0's device)."""
        dt = torch.promote_types(self.dtype, torch.float32)
        vals = self._each_group(flat, lambda d, shards: self.group_losses(
            d, shards, self._rows(xb, d), self._rows(yb, d)).mean().to(dt)
            .reshape(1))
        return ring_all_reduce_bidir(vals, scale=1.0 / self.lay.dp)[0] \
            .reshape(())

    def _batch(self, xb) -> torch.Tensor:
        """A batch as a tensor, its rows checked against the microbatch
        grid."""
        x = xb if isinstance(xb, torch.Tensor) else torch.as_tensor(
            np.asarray(xb))
        if x.shape[0] % self.M or (x.shape[0] // self.M) % self.lay.dp:
            raise ValueError(
                f"a batch of {x.shape[0]} rows does not split into "
                f"{self.M} microbatches of rows divisible by the data-axis "
                f"size ({self.lay.dp})")
        return x

    def value_and_grad(self, flat, xb, yb):
        """The batch-mean loss (0-d, rank 0's device) and its gradients as
        :class:`~.mesh.Sharded` leaves on the partition's specs: each data
        group's :meth:`group_vag`, then each leaf's mean over the data axis
        (kernel 9, one call per stage rank when dp > 1)."""
        mesh, lay = self.mesh, self.lay
        placed = _placed(flat, self.specs, mesh)
        xb, yb = self._batch(xb), self._batch(yb)
        n = len(placed)
        vals, grads = [], [None] * mesh.size
        for d, group in enumerate(self.groups):
            dev = lay.dev(group[0])
            v, g = self.group_vag(d)(
                _split_rows(xb, lay.dp, d, dev, chunks=self.M),
                _split_rows(yb, lay.dp, d, dev, chunks=self.M),
                tuple(p.shards[r] for r in group for p in placed))
            vals.append(v.reshape(1))
            for k, r in enumerate(group):
                grads[r] = g[k * n:(k + 1) * n]
        v = ring_all_reduce_bidir(vals, scale=1.0 / lay.dp)[0].reshape(())
        return v, tuple(reduce_mean([g[i] for g in grads], p.spec, mesh)
                        for i, p in enumerate(placed))

    def forward(self, flat, xb):
        """The pipelined network's output rows, in order, on rank 0's
        device (kernel 9's ``ag`` over the data groups' home ranks when dp
        > 1)."""
        outs = self._each_group(flat, lambda d, shards: self.group_output(
            d, shards, self._rows(xb, d)))
        if self.lay.dp == 1:
            return outs[0]
        rows = _all_gather(outs, 0)[0]
        o = rows.shape[-1]
        return (rows.reshape(self.lay.dp, self.M, -1, o).transpose(0, 1)
                .reshape(-1, o))


def _segment_params(ops, row) -> list:
    """The params of each op of ``ops``, unpacked from the flat ``row``."""
    flat = _unpack(row, ops)
    out, i = [], 0
    for op in ops:
        k = len(op.in_stack) - 1
        out.append(flat[i:i + k])
        i += k
    return out


def _warn_idle(what: str) -> None:
    import warnings

    warnings.warn(f"staged-IR pipeline: {what}", stacklevel=3)


def make_ir_pipeline_loss(net: Network, loss: TOp, be, mesh: Mesh,
                          n_microbatches: int, pnet=None,
                          schedule: str = "gpipe", n_chunks: int = 2):
    """``(loss_fn, pnet)``: the pipelined batch-mean loss over the
    stage-partitioned flat params, ``loss_fn(flat_params, xb, yb)`` (a 0-d
    tensor on rank 0's device; ``flat_params`` placed leaves or arrays,
    placed first).  ``loss_fn.value_and_grad(flat_params, xb, yb)`` adds
    the gradients (every segment through its own transposition, see
    :func:`batched_ir_call`; autograd orchestrates the schedule),
    ``loss_fn.forward(flat_params, xb)`` is the network's output and
    ``loss_fn.group_vag(d)`` data group ``d``'s step of ``fit``.

    ``pnet`` may be a prebuilt partition (or a skeleton of one: only its
    structure is used).  Uniform-body networks take the stacked-params
    cut (:func:`split_network`); any other ``then``-chain the heterogeneous
    FLOP-balanced one (:func:`split_network_hetero`), tensor-parallel over
    the mesh's model axis when every segment row-splits
    (:func:`split_network_hetero_tp`).  A uniform body that matches the
    ffLayer pattern row-splits over the model axis too
    (:func:`pipeline_tp_segment`); a partition that cannot leaves the
    model axis idle, with a warning.
    ``schedule="circular"`` runs the interleaved schedule: each device
    holds ``n_chunks`` (V) round-robin chunks of the chain and the
    activation ring wraps V times, shrinking the bubble to (S-1)/(VM+S-1);
    it requires ``n_microbatches >= S`` (M > S buffers the wrap in a
    depth-(M-S) FIFO).  On a bf16 backend the forward and backward run in
    bf16 on the masters the leaves hold (``fit``'s ``mixed_precision``)."""
    if be.name != "torch":
        raise ValueError("ir pipeline requires the torch backend")
    S = _check_mesh(mesh, "make_ir_pipeline_loss")
    tp = _model_size(mesh)
    if pnet is None:
        pnet = (partition_network_circular(net, S, n_chunks, mesh)
                if schedule == "circular" else partition_network(net, S, mesh))
    circ_uniform = isinstance(pnet, CircularPipelinedNetwork)
    if isinstance(pnet, (HeteroCircularPipelinedNetwork,
                         HeteroTpCircularPipelinedNetwork)):
        if schedule != "circular":
            raise ValueError("a hetero circular partition runs only under "
                             "schedule='circular'")
        built = pnet.S
        if isinstance(pnet, HeteroCircularPipelinedNetwork) and tp > 1:
            _warn_idle(
                "this heterogeneous circular partition does not shard over "
                "the model axis (a segment doesn't match the row-shardable "
                "ffLayer pattern or its width doesn't divide the model-axis "
                "size) — it will sit idle (replicated chunks)")
    elif isinstance(pnet, HeteroTpPipelinedNetwork):
        if schedule == "circular":
            raise ShapeError(
                "the circular schedule needs a hetero-circular partition "
                "for this network: build pnet with "
                "split_network_hetero_tp_circular (or omit pnet)")
        built = pnet.n_stages
    elif isinstance(pnet, HeteroPipelinedNetwork):
        if schedule == "circular":
            raise ShapeError(
                "the circular schedule needs chunk-ordered params: build "
                "pnet with split_network_hetero_circular (or omit pnet)")
        built = pnet.n_stages
        if tp > 1:
            _warn_idle("heterogeneous partitions do not shard over the "
                       "model axis — it will sit idle (replicated stages)")
    else:
        if schedule == "circular" and not circ_uniform:
            raise ValueError(
                "schedule='circular' needs a circular partition: omit pnet "
                "or build it with split_network_circular")
        built = pnet.n_stages if circ_uniform else S
        if tp > 1 and pipeline_tp_segment(pnet, mesh) is None:
            _warn_idle(
                "the body segment does not match the row-shardable ffLayer "
                "pattern (or its width does not divide the model-axis "
                "size) — the model axis will sit idle (replicated body)")
    if built != S:
        # the stage-split rows (and a circular cut's interleave) are
        # S-specific: another stage count would train another network
        raise ValueError(
            f"partition was built for {built} stages but the mesh's stage "
            f"axis is {S} — rebuild pnet for this mesh (or omit it)")
    if _tp_partition(pnet) and pnet.tp != tp:
        raise ValueError(
            f"partition was row-split over {pnet.tp} model ranks but the "
            f"mesh's model axis is {tp} — rebuild pnet for this mesh (or "
            f"omit it)")
    circular = schedule == "circular"
    if circular and n_microbatches < S:
        raise ValueError(
            f"circular schedule requires n_microbatches ({n_microbatches}) "
            f">= stage-axis size ({S})")
    if _uniform(pnet) and pnet.n_body % (S * (pnet.n_chunks if circ_uniform
                                              else 1)):
        raise ShapeError(f"the body's {pnet.n_body} segments do not split "
                         f"over {S} stages")
    return _PipelinedLoss(pnet, loss, be, mesh, n_microbatches,
                          circular), pnet


def ir_pipeline_train_step(net: Network, loss: TOp, be, mesh: Mesh,
                           n_microbatches: int, schedule: str = "gpipe",
                           n_chunks: int = 2):
    """Pipeline-parallel SGD step over the staged IR: ``fn(lr, xb, yb,
    *flat_params) -> (mean_loss, new_flat_params)`` (placed
    :class:`~.mesh.Sharded` leaves; arrays are placed first).  Returns
    ``(step, pnet)``; ``pnet.flat_params()`` feeds the step and
    ``pnet.unflatten(new).to_network_params()`` rebuilds a Network stack.
    Every segment's gradient is its ``op.transpose``."""
    loss_fn, pnet = make_ir_pipeline_loss(net, loss, be, mesh,
                                          n_microbatches, schedule=schedule,
                                          n_chunks=n_chunks)

    def step(lr, xb, yb, *flat_params):
        v, grads = loss_fn.value_and_grad(flat_params, xb, yb)
        return v, tuple(g.map(lambda a, b: b - lr * a, p) for g, p in
                        zip(grads, _placed(flat_params, loss_fn.specs, mesh)))

    return step, pnet


def _placed(flat, specs, mesh) -> tuple:
    return tuple(x if isinstance(x, Sharded) else place(x, s, mesh)
                 for x, s in zip(flat, specs))


def ir_pipeline_grads(net: Network, loss: TOp, be, mesh: Mesh,
                      n_microbatches: int, schedule: str = "gpipe",
                      n_chunks: int = 2) -> Callable:
    """``fn(xb, yb, *flat_params) -> (mean_loss, grads)``: the raw pipelined
    batch-mean gradient (:class:`~.mesh.Sharded` leaves on the partition's
    specs), for direct comparison against the sequential staged-IR
    gradient."""
    loss_fn, _ = make_ir_pipeline_loss(net, loss, be, mesh, n_microbatches,
                                       schedule=schedule, n_chunks=n_chunks)

    def grads(xb, yb, *flat_params):
        return loss_fn.value_and_grad(flat_params, xb, yb)

    return grads


def staged_forward(net: Network, be) -> Callable:
    """``fn(xb) -> yb``: the network's segments in chain order, each on the
    device that holds its parameters (a pipeline's ``to_network_params``
    leaves each stage's on its rank), the activation handed from one to
    the next; the output on the last segment's device.  ``fit``'s
    validation on a stage mesh: no stage's leaves move."""
    from .mesh import _rank_backend

    segs = network_segments(net)
    runs = []
    dev = torch.device(be.device)
    for op, ps in segs:
        if ps:
            dev = ps[0].device
        be_d = _rank_backend(be, dev)
        runs.append((dev, torch.func.vmap(
            lambda x, *p, op=op, be_d=be_d: op.apply(be_d, (x,) + p)[0],
            in_dims=(0,) + (None,) * len(ps)), ps))

    def fwd(xb):
        h = xb
        with torch.no_grad():
            for dev, run, ps in runs:
                h = run(h.to(dev), *ps)
        return h

    return fwd


# ---------------------------------------------------------------------------
# partition introspection
# ---------------------------------------------------------------------------


def describe_partition(pnet) -> str:
    """Human-readable stage map of a pipeline partition: per-stage segment
    counts, boundary widths, parameter counts, FLOP estimates and the
    load-balance ratio (max/mean stage FLOPs; 1.00 is perfect), for every
    kind ``partition_network`` / ``partition_network_circular`` return:
    uniform, circular, heterogeneous and heterogeneous circular, and both
    heterogeneous kinds tensor-parallel."""
    lines: List[str] = []

    def seg_width(op: TOp) -> str:
        i = op.in_stack[0]
        o = op.out_stack[0]
        return f"{i[0] if len(i) == 1 else i}->{o[0] if len(o) == 1 else o}"

    def seg_nparams(op: TOp) -> int:
        return int(sum(np.prod(s, dtype=np.int64) if s else 1
                       for s in op.in_stack[1:]))

    def tagged(ops, locs) -> str:
        return ", ".join(seg_width(op) + (" (+replicated tail)"
                                          if suf is not None else "")
                         for op, (_, suf) in zip(ops, locs))

    if isinstance(pnet, HeteroTpCircularPipelinedNetwork):
        lines.append(
            f"heterogeneous circular x tp partition: {pnet.S} stages x "
            f"{pnet.V} chunks/device, tp={pnet.tp}, ring width "
            f"{pnet.width}, packed rows (S={pnet.S}, V={pnet.V}, "
            f"tp={pnet.tp}, Lmax={pnet.lmax})")
        flops = []
        for c, (ops_c, locs) in enumerate(zip(pnet.chunk_ops,
                                              pnet.local_ops)):
            f = sum(_op_flops(op) for op in ops_c)
            flops.append(f)
            lines.append(
                f"  chunk {c} (device {c % pnet.S}, slot {c // pnet.S}): "
                f"{len(ops_c)} segment(s) [{tagged(ops_c, locs)}], "
                f"{sum(seg_nparams(op) for op in ops_c)} params "
                f"(1/{pnet.tp} per shard), ~{f:.0f} FLOPs/sample")
        # a device runs ALL its V chunks: balance is over per-device sums
        flops = [sum(flops[c] for c in range(len(flops))
                     if c % pnet.S == d) for d in range(pnet.S)]
    elif isinstance(pnet, HeteroCircularPipelinedNetwork):
        lines.append(
            f"heterogeneous circular partition: {pnet.S} stages x "
            f"{pnet.V} chunks/device, ring width {pnet.width}, packed "
            f"rows (S={pnet.S}, V={pnet.V}, Lmax={pnet.lmax})")
        flops = []
        for c, ops_c in enumerate(pnet.chunk_ops):
            f = sum(_op_flops(op) for op in ops_c)
            flops.append(f)
            lines.append(
                f"  chunk {c} (device {c % pnet.S}, slot {c // pnet.S}): "
                f"{len(ops_c)} segment(s) "
                f"[{', '.join(seg_width(op) for op in ops_c)}], "
                f"{sum(seg_nparams(op) for op in ops_c)} params, "
                f"~{f:.0f} FLOPs/sample")
        # a device runs ALL its V chunks: balance is over per-device sums
        flops = [sum(flops[c] for c in range(len(flops))
                     if c % pnet.S == d) for d in range(pnet.S)]
    elif isinstance(pnet, HeteroTpPipelinedNetwork):
        lines.append(
            f"heterogeneous x tp partition: {pnet.n_stages} stages, "
            f"tp={pnet.tp}, ring width {pnet.width}, packed rows "
            f"(S={pnet.n_stages}, tp={pnet.tp}, Lmax={pnet.lmax})")
        flops = []
        for s, (ops_s, locs) in enumerate(zip(pnet.stage_ops,
                                              pnet.local_ops)):
            f = sum(_op_flops(op) for op in ops_s)
            flops.append(f)
            lines.append(
                f"  stage {s}: {len(ops_s)} segment(s) [{tagged(ops_s, locs)}]"
                f", {sum(seg_nparams(op) for op in ops_s)} params"
                f" (1/{pnet.tp} per shard), ~{f:.0f} FLOPs/sample")
    elif isinstance(pnet, HeteroPipelinedNetwork):
        lines.append(
            f"heterogeneous partition: {pnet.n_stages} stages, ring "
            f"width {pnet.width}, packed rows (S={pnet.n_stages}, "
            f"Lmax={pnet.lmax})")
        flops = []
        for s, ops_s in enumerate(pnet.stage_ops):
            f = sum(_op_flops(op) for op in ops_s)
            flops.append(f)
            lines.append(
                f"  stage {s}: {len(ops_s)} segment(s) "
                f"[{', '.join(seg_width(op) for op in ops_s)}], "
                f"{sum(seg_nparams(op) for op in ops_s)} params, "
                f"~{f:.0f} FLOPs/sample")
    elif isinstance(pnet, PipelinedNetwork):
        circ = isinstance(pnet, CircularPipelinedNetwork)
        kind = "circular (interleaved)" if circ else "uniform"
        head = (f"{kind} partition: {pnet.n_body} identical body "
                f"segment(s) [{seg_width(pnet.body_op)}], "
                f"{len(pnet.pre)} pre / {len(pnet.post)} post "
                f"replicated segment(s)")
        if circ:
            head += (f", {pnet.n_chunks} chunks/device over "
                     f"{pnet.n_stages} stages")
        lines.append(head)
        per = _op_flops(pnet.body_op)
        lines.append(
            f"  body segment: {seg_nparams(pnet.body_op)} params, "
            f"~{per:.0f} FLOPs/sample; stage load is exactly balanced "
            f"(identical segments)")
        for name, part in (("pre", pnet.pre), ("post", pnet.post)):
            for op, ps in part:
                lines.append(
                    f"  {name}: [{seg_width(op)}], "
                    f"{seg_nparams(op)} params (replicated)")
        flops = [per]
    else:
        raise TypeError(f"not a pipeline partition: {type(pnet).__name__}")
    if len(flops) > 1:
        mean = sum(flops) / len(flops)
        lines.append(f"  balance: max/mean stage FLOPs = "
                     f"{max(flops) / mean:.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the row-parallel split of a segment (the model axis's executor, .tp)
# ---------------------------------------------------------------------------


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
