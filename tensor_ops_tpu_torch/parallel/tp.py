"""Tensor parallelism over a mesh's model axis: the executor of a network
graph, and of a ``FusedMLP``, whose weights are placed by ``param_specs``.

This module has no counterpart in the JAX package: there GSPMD partitions
the jitted program from the weights' shardings and inserts the collectives.
Here the executor walks the network's layer segments
(:func:`.ir_pipeline.network_segments`) on one model group (the ranks of
one data rank) and tracks whether the activation is whole on every model
rank or split over the model axis along its feature dimension:

* a row-parallel layer (weight on ``(model, None)``) takes the whole
  activation; its local segment (:func:`.ir_pipeline.
  _tp_local_segment_split`: the affine part and the elementwise prefix of
  the tail at width o/tp) leaves it split; a non-elementwise suffix (the
  softmax normalization) runs at full width after an all-gather;
* a column-parallel layer (weight on ``(None, model)``) takes the split
  activation (a whole one is sliced, which moves nothing); its partial
  products go through an all-reduce before the replicated bias and tail;
* a layer whose weight is replicated takes the whole activation;
* any other segment (a graph built another way, a weight the split cannot
  take) runs on its weights all-gathered over the model axis at each use,
  with one warning per network naming it: the results are the same and
  the leaves stay sharded at rest.  A recurrent ``gen_net`` chain has an
  executor of its own (:mod:`.tp_seq`), on these rules.

The backward is the IR's own transposition of each local segment (a
vmapped VJP, which recomputes the segment's forward), each collective
replaced by its transpose: the activation all-gather by a slice of the
whole cotangent every model rank holds, the whole input of a row-parallel
layer by an all-reduce of the partial input cotangents, the all-reduce of
partial products by the identity, a slice by an all-gather.  The loss runs
on every model rank on the whole output and model rank 0's value is
reported; the gradients of model-sharded leaves are each rank's own, those
of replicated leaves the same on every model rank.

Every collective is a call of kernel 9's wrappers on the group's tensors
(:mod:`.collective_kernels`): the one-shot for ranks that share a card,
the ring protocol across cards.  Kernel 9 moves f32 and int32: bf16
activations cross an all-reduce as f32 and an all-gather as int32 words
(two bf16 a word) where their last dimension is even, else as f32
(``mesh._all_gather``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops import ir
from ..ops import prim as P
from ..ops.ir import TOp
from .collective_kernels import ring_all_reduce_bidir
from .ir_pipeline import _flat, _tp_local_segment_split, network_segments
from .mesh import MODEL_AXIS, _all_gather, _axis_dim, _full

ROW, COL, REPL, GATHER = "row", "col", "replicated", "gathered"


# ---------------------------------------------------------------------------
# Collectives on activations (kernel 9, one call per model group)
# ---------------------------------------------------------------------------


def _sum(xs) -> List[torch.Tensor]:
    """All-reduce (sum) of the group's tensors (kernel 9's ``ar``); bf16
    is summed in f32."""
    x0 = xs[0]
    if x0.dtype in (torch.bfloat16, torch.float16):
        return [y.to(x0.dtype) for y in ring_all_reduce_bidir(
            [x.float() for x in xs])]
    return ring_all_reduce_bidir(list(xs))


def _block(x: torch.Tensor, m: int, tp: int, dim: int = -1) -> torch.Tensor:
    """Model rank ``m``'s block of ``x``'s dimension ``dim``: a view, which
    moves nothing."""
    w = x.shape[dim] // tp
    return x.narrow(dim, m * w, w)


def _feature_gather(hs) -> List[torch.Tensor]:
    """All-gather of the group's feature blocks (the last dimension)."""
    return _all_gather(hs, hs[0].dim() - 1)


# ---------------------------------------------------------------------------
# The plan: one entry per layer segment
# ---------------------------------------------------------------------------


def _tp_column_segment_split(op: TOp, tp: int
                             ) -> Optional[Tuple[TOp, TOp]]:
    """Column-parallel split of an ffLayer segment (the same pattern as
    :func:`.ir_pipeline._tp_local_segment_split`) when ``tp`` divides its
    input width ``i``: ``(partial, rest)``, ``partial`` the product of the
    activation's block and the weight's column block (``(i/tp,), (o,
    i/tp) -> (o,)``), ``rest`` the bias add and the whole tail at full
    width (``(o,), (o,) -> out``), run after the partial products'
    all-reduce.  None when the segment does not match."""
    from ..ops.ir import First, GMul, Shuffle, SumOp

    nodes = _flat(op)
    if len(nodes) < 2 or not isinstance(nodes[0], First):
        return None
    inner = _flat(nodes[0].op)
    if len(inner) != 2:
        return None
    sw, gm = inner
    if not (isinstance(sw, Shuffle) and sw.idxs == (1, 0)
            and isinstance(gm, GMul) and len(gm.ms) == 1
            and len(gm.os) == 1 and not gm.ns):
        return None
    o, i = gm.ms[0], gm.os[0]
    if i % tp != 0 or nodes[0].rest != ((o,),):
        return None
    if not (isinstance(nodes[1], SumOp) and nodes[1].n == 2
            and nodes[1].shape == (o,)):
        return None
    i_l = i // tp
    partial = P.swap((i_l,), (o, i_l)) >> P.mat_vec(o, i_l)
    rest = nodes[1]
    for nd in nodes[2:]:
        rest = rest >> nd
    return partial, rest


@dataclass
class _Seg:
    kind: str                 # ROW, COL, REPL or GATHER
    idx: Tuple[int, ...]      # the segment's leaves among the network's
    ops: Tuple[TOp, ...]      # ROW (local, suffix), COL (partial, rest),
    #                           REPL / GATHER (the segment,)
    mdims: Tuple[Optional[int], ...]  # each leaf's model dimension
    name: str


def plan(net, specs, tp: int) -> List[_Seg]:
    """The executor's plan of ``net`` on a model axis of ``tp`` ranks, its
    leaves on ``specs`` (``param_specs``): one :class:`_Seg` per layer
    segment."""
    segs, cursor = [], 0
    for k, (op, ps) in enumerate(network_segments(net)):
        idx = tuple(range(cursor, cursor + len(ps)))
        cursor += len(ps)
        sp = [_full(specs[i], len(net.param_stack[i])) for i in idx]
        mdims = tuple(_axis_dim(s, MODEL_AXIS) if tp > 1 else None
                      for s in sp)
        name = f"segment {k} {op!r}"
        split = None
        if tp > 1 and len(idx) == 2 and sp[1] == (MODEL_AXIS,) \
                and sp[0] == (MODEL_AXIS, None):
            split = (ROW, _tp_local_segment_split(op, tp))
        elif tp > 1 and len(idx) == 2 and sp[1] == (None,) \
                and sp[0] == (None, MODEL_AXIS):
            split = (COL, _tp_column_segment_split(op, tp))
        if split is not None and split[1] is not None:
            segs.append(_Seg(split[0], idx, tuple(split[1]), mdims, name))
        elif all(m is None for m in mdims):
            segs.append(_Seg(REPL, idx, (op,), mdims, name))
        else:
            segs.append(_Seg(GATHER, idx, (op,), mdims, name))
    return segs


def warn_gathered(owner, names: Sequence[str], tp: int) -> None:
    """The one warning per network (``owner``: its op, whose compiled-graph
    cache remembers it) for segments that run on gathered weights."""
    if not names:
        return
    key = ("tp_gathered_warned", tp, tuple(names))
    if owner._compiled.get(key):
        return
    owner._compiled[key] = True
    warnings.warn(
        f"tensor parallelism over {tp} model ranks: {len(names)} segment(s) "
        f"do not match the row- or column-parallel ffLayer pattern and run "
        f"on their weights all-gathered over the model axis at each use "
        f"(the same results; the leaves stay sharded at rest): "
        f"{'; '.join(names)}", stacklevel=4)


# ---------------------------------------------------------------------------
# The executor of a network graph on one model group
# ---------------------------------------------------------------------------


def _vm(fn: Callable, n_batched: int, n_params: int, n_after: int = 0):
    return torch.func.vmap(fn, in_dims=(0,) * n_batched + (None,) * n_params
                           + (0,) * n_after)


class TpNetwork:
    """``net`` on one model group: ``devices`` are the group's model ranks
    in order, ``be`` the backend whose dtype the step computes in
    (``compute`` overrides it: the bf16 step's forward and backward, its
    values and gradients upcast to f32 before the batch mean).

    ``forward(x, ps)`` and ``value_and_grad(loss, x, y, ps)`` take the
    batch on the group's first device and ``ps``, one tuple of the
    network's leaves per model rank (each rank's blocks); the second
    returns the mean loss (model rank 0's) and one tuple of mean
    gradients per model rank, each leaf's gradient in its block's shape."""

    def __init__(self, net, specs, devices: Sequence[torch.device], be,
                 compute: Optional[torch.dtype] = None):
        from ..backend.torch_backend import TorchBackend

        self.net = net
        self.devices = tuple(devices)
        self.tp = len(self.devices)
        self.compute = compute
        dtype = compute or be.dtype
        self.bes = [TorchBackend(dtype, d) for d in self.devices]
        self.n_leaves = len(net.params)
        self.segs = plan(net, specs, self.tp)
        warn_gathered(net.op, [s.name for s in self.segs
                               if s.kind == GATHER], self.tp)
        self._fns: dict = {}

    # -- the vmapped per-sample pieces, one per (op, rank) --------------
    # the ops are the plan's, alive as long as the executor: their ids key
    # the vmapped functions
    def _fwd(self, op: TOp, m: int, n_params: int):
        key = ("f", id(op), m)
        if key not in self._fns:
            be = self.bes[m]
            self._fns[key] = _vm(lambda *a: op.apply(be, a)[0], 1, n_params)
        return self._fns[key]

    def _bwd(self, op: TOp, m: int, n_params: int):
        """``fn(x, *params, ct) -> per-sample cotangents of (x, *params)``."""
        key = ("b", id(op), m)
        if key not in self._fns:
            be = self.bes[m]
            self._fns[key] = _vm(
                lambda *a: ir.vjp(op, be, a[:-1], (a[-1],)), 1, n_params, 1)
        return self._fns[key]

    def _gathered(self, seg: _Seg, ws):
        """The segment's leaves whole on every model rank: each leaf on the
        model axis all-gathered along its model dimension."""
        out = [list(w) for w in ws]
        for j, md in enumerate(seg.mdims):
            if md is not None:
                for m, y in enumerate(_all_gather([w[j] for w in ws], md)):
                    out[m][j] = y
        return out

    def _forward(self, x, ps):
        """The forward on the group: the whole output on every model rank,
        and what the backward needs of each segment: ``(seg, moved, h, ws,
        z)``, ``moved`` whether its input was gathered (ROW, REPL, GATHER)
        or sliced (COL), ``h`` its input on each rank, ``ws`` the leaves it
        ran on (GATHER: whole), ``z`` the whole pre-suffix (ROW) or the
        summed product (COL)."""
        tp = self.tp
        h = [x.to(d) for d in self.devices]
        split = False
        records = []
        for seg in self.segs:
            ws = [[ps[m][i] for i in seg.idx] for m in range(tp)]
            z = None
            if seg.kind == COL:
                moved = not split
                if moved:
                    h = [_block(h[m], m, tp) for m in range(tp)]
                partial, rest = seg.ops
                z = _sum([self._fwd(partial, m, 1)(h[m], ws[m][0])
                          for m in range(tp)])
                out = [self._fwd(rest, m, 1)(z[m], ws[m][1])
                       for m in range(tp)]
                split = False
            else:
                moved = split
                if split:
                    h = _feature_gather(h)
                if seg.kind == ROW:
                    local, suffix = seg.ops
                    out = [self._fwd(local, m, 2)(h[m], *ws[m])
                           for m in range(tp)]
                    split = suffix is None
                    if suffix is not None:
                        z = _feature_gather(out)
                        out = [self._fwd(suffix, m, 0)(z[m])
                               for m in range(tp)]
                else:
                    if seg.kind == GATHER:
                        ws = self._gathered(seg, ws)
                    op = seg.ops[0]
                    out = [self._fwd(op, m, len(seg.idx))(h[m], *ws[m])
                           for m in range(tp)]
                    split = False
            records.append((seg, moved, h, ws, z))
            h = out
        if split:
            h = _feature_gather(h)
        return h, records, split

    def _backward(self, records, out_split: bool, ct):
        """Per-sample gradients of every leaf on every model rank (each
        rank's block), from the whole output cotangent ``ct`` on each."""
        tp = self.tp
        grads = [[None] * len(self.net.params) for _ in range(tp)]
        if out_split:
            ct = [_block(ct[m], m, tp) for m in range(tp)]
        for k in range(len(records) - 1, -1, -1):
            seg, moved, h, ws, z = records[k]
            if seg.kind == COL:
                partial, rest = seg.ops
                o_r = [self._bwd(rest, m, 1)(z[m], ws[m][1], ct[m])
                       for m in range(tp)]
                # the all-reduce of partial products: its transpose is
                # the identity on the whole cotangent each rank holds
                o_p = [self._bwd(partial, m, 1)(h[m], ws[m][0], o_r[m][0])
                       for m in range(tp)]
                per = [(o_p[m][1], o_r[m][1]) for m in range(tp)]
                ct = [o_p[m][0] for m in range(tp)]
                if k and moved:
                    ct = _feature_gather(ct)
            elif seg.kind == ROW:
                local, suffix = seg.ops
                if suffix is not None:
                    ct = [_block(self._bwd(suffix, m, 0)(z[m], ct[m])[0], m,
                                 tp) for m in range(tp)]
                o = [self._bwd(local, m, 2)(h[m], *ws[m], ct[m])
                     for m in range(tp)]
                per = [o[m][1:] for m in range(tp)]
                if k:
                    # the whole input: the ranks' partial cotangents summed
                    ct = _sum([o[m][0] for m in range(tp)])
                    if moved:
                        ct = [_block(ct[m], m, tp) for m in range(tp)]
            else:
                op = seg.ops[0]
                o = [self._bwd(op, m, len(seg.idx))(h[m], *ws[m], ct[m])
                     for m in range(tp)]
                per = [o[m][1:] for m in range(tp)]
                if seg.kind == GATHER:
                    # the gather's transpose: each rank's block of the
                    # whole gradient every rank holds
                    per = [tuple(g if md is None else _block(g, m, tp, md + 1)
                                 for g, md in zip(per[m], seg.mdims))
                           for m in range(tp)]
                if k:
                    ct = [o[m][0] for m in range(tp)]
                    if moved:
                        ct = [_block(ct[m], m, tp) for m in range(tp)]
            for m in range(tp):
                for i, g in zip(seg.idx, per[m]):
                    grads[m][i] = g
        return grads

    def _cast(self, ps):
        c = self.compute
        return [tuple(p.to(c) for p in pm) for pm in ps] if c else ps

    def forward(self, x, ps) -> torch.Tensor:
        """The batched forward of ``x``: the whole output on the group's
        first device (model rank 0's)."""
        if self.compute:
            x = x.to(self.compute)
        return self._forward(x, self._cast(ps))[0][0]

    def value_and_grad(self, loss: TOp, x, y, ps):
        c = self.compute
        if c:
            x, y = x.to(c), y.to(c)
        out, records, split = self._forward(x, self._cast(ps))
        lv = []
        for m in range(self.tp):
            key = ("loss", loss.struct_key(), m)
            if key not in self._fns:
                be = self.bes[m]
                self._fns[key] = torch.func.vmap(
                    lambda yy, t: ir.value_and_grad(loss, be, (yy, t)))
            lv.append(self._fns[key](out[m], y.to(self.devices[m])))
        grads = self._backward(records, split, [v[1][0] for v in lv])
        v = lv[0][0]
        if c:
            v = v.float()
            grads = [[g.float() for g in gm] for gm in grads]
        return v.mean(), [tuple(g.mean(dim=0) for g in gm) for gm in grads]


# ---------------------------------------------------------------------------
# Group steps for the mesh loops
# ---------------------------------------------------------------------------


def group_vag(tpnet, loss: TOp) -> Callable:
    """``fn(x, y, ps) -> (mean loss, grads)`` for ``trainer._mesh_step`` of
    a :class:`TpNetwork` (or a ``tp_seq.SeqTpNetwork``): ``ps`` and
    ``grads`` flat in model-rank-major order (rank 0's leaves, then rank
    1's, ...)."""
    n = tpnet.n_leaves

    def vag(x, y, ps):
        v, grads = tpnet.value_and_grad(
            loss, x, y, [ps[m * n:(m + 1) * n] for m in range(tpnet.tp)])
        return v, tuple(g for gm in grads for g in gm)

    return vag


def gathered_vag(vags: Sequence[Callable], specs, devices) -> Callable:
    """The step of a recurrent graph that is no ``gen_net`` chain, for
    ``trainer._mesh_step``: ``vags[m](x, y, leaves)`` (one per model rank,
    on its device) run on the leaves all-gathered over the model axis;
    each rank keeps its block of each model-sharded leaf's gradient.
    ``ps`` and the grads flat in model-rank-major order, as
    :func:`group_vag`'s."""
    tp = len(devices)
    n = len(specs)
    mdims = [_axis_dim(_full(s, len(s)), MODEL_AXIS) for s in specs]

    def vag(x, y, ps):
        per = [list(ps[m * n:(m + 1) * n]) for m in range(tp)]
        for i, md in enumerate(mdims):
            if md is not None:
                for m, w in enumerate(_all_gather([p[i] for p in per], md)):
                    per[m][i] = w
        res = [vags[m](x.to(devices[m]), y.to(devices[m]), tuple(per[m]))
               for m in range(tp)]
        grads = tuple(g if md is None else _block(g, m, tp, md)
                      for m in range(tp)
                      for g, md in zip(res[m][1], mdims))
        return res[0][0], grads

    return vag


# ---------------------------------------------------------------------------
# Tensor-parallel serving of a FusedMLP (parallel.mesh.shard_fused)
# ---------------------------------------------------------------------------


def fused_forward(fm, x: torch.Tensor) -> torch.Tensor:
    """``FusedMLP.run_xla`` of a model whose weights and biases are
    :class:`~tensor_ops_tpu_torch.parallel.mesh.Sharded` by
    ``param_specs``: the same plain PyTorch layers, each model group
    running the row-, column-parallel or replicated form of each layer (as
    :class:`TpNetwork` does), the batch replicated over the data axis as in
    the JAX package (every data rank serves it, and on a stage axis every
    stage rank, which holds the same copies); returns the first model
    group's output on its first device (under several processes, this
    process's first group's: a model group lies in one process)."""
    from ..ops.kernels import _act_fn

    mesh = fm.weights[0].mesh
    tp = mesh.shape.get(MODEL_AXIS, 1)
    n = len(fm.weights)
    out = None
    for group in mesh.groups(MODEL_AXIS):
        if not mesh.is_local(group[0]):
            continue  # another process's model group
        devs = [mesh.rank_devices[r] for r in group]
        h = [x.to(d) for d in devs]
        dt = x.dtype
        split = False
        for k, (W, b) in enumerate(zip(fm.weights, fm.biases)):
            ws = [W.shards[r].to(dt) for r in group]
            bs = [b.shards[r].to(dt) for r in group]
            soft = k == n - 1 and fm.softmax_out
            act = ((lambda z: torch.softmax(z, dim=-1)) if soft
                   else _act_fn(fm.acts[k]))
            if W.mdim == 1:
                if not split:
                    h = [_block(h[m], m, tp) for m in range(tp)]
                z = _sum([h[m] @ ws[m].T for m in range(tp)])
                h = [act(z[m] + bs[m]) for m in range(tp)]
                split = False
                continue
            if split:
                h = _feature_gather(h)
            z = [h[m] @ ws[m].T + bs[m] for m in range(tp)]
            split = W.mdim == 0
            if split and soft:
                z, split = _feature_gather(z), False
            h = [act(zm) for zm in z]
        if split:
            h = _feature_gather(h)
        out = h[0] if out is None else out
    return out
