"""The recurrent family on a mesh's model axis: a ``gen_net`` chain of
Elman cells and ffLayers whose leaves ``param_specs`` places, run on one
model group timestep by timestep, each weight on its own spec.

This module has no counterpart in the JAX package: there GSPMD partitions
the jitted scan from the weights' shardings.  Here the executor walks the
chain layer by layer (a cell's state depends only on its own past and its
input, so each layer runs over the whole sequence before the next), each
matrix product in the form its weight's spec gives it (:mod:`.tp`'s rules):

* a row-parallel weight (``(model, None)``) takes the whole activation and
  leaves its rows split; a column-parallel one (``(None, model)``) takes
  the split activation (a whole one is sliced, which moves nothing) and
  all-reduces its partial products; a replicated one takes the whole
  activation; a bias is on its weight's output spec;
* a cell ``z = wS.s + wX.x + b`` (output ``z``, new state ``sact(z)``)
  takes ``wX.x + b`` for every timestep before its scan (the input is
  known: a column-parallel ``wX``'s all-reduce runs once a sequence); at
  each timestep model rank m computes its part of ``wS.s``: with ``wS``
  row-parallel its rows ``z[R_m] = wS[R_m, :].s + (wX.x + b)[R_m]``, which
  an all-gather over the model axis makes whole, with ``wS``
  column-parallel the all-reduce of its partial products.  The whole
  ``z`` on every rank gives the next state (the state stays replicated,
  ``(None,)``, as ``fit_sequences`` places it) and the cell's output;
* an ffLayer's elementwise activation runs on a row-split output; any
  other activation (the softmax) runs after an all-gather; the chain's
  output is made whole for the loss, which every model rank takes (model
  rank 0's value is reported).

The backward is BPTT through the same pieces, each collective replaced by
its transpose: the state's all-gather by a slice of the whole cotangent
every model rank holds, the whole state (or input) of a row-parallel
product by an all-reduce of the ranks' partial cotangents, an all-reduce
of partial products by the identity, a slice by an all-gather.  The
per-sequence gradients are formed as the JAX package's vmapped scan forms
them (each weight's summed over the timesteps of its sequence), upcast
before the batch mean in the bf16 step.  Each model-sharded leaf's
gradient is its rank's block; a replicated leaf's (the states among them)
is the same on every model rank.  No weight is gathered at any use.

``fit_sequences``' memory options act as they do on the single-device
scan (``ops.loops.ScanOp``): ``remat_every=k`` keeps a cell's state only
at each block of k timesteps' entry (its ``wX.x + b`` kept whole) and the
backward recomputes the block's timesteps, their collectives included,
before it reverses them; ``offload_activations`` streams those kept states
through pinned host memory (every timestep's, without ``remat_every``).
The values are the same; only each block's weight gradient is summed
block by block.

Every collective is one call of kernel 9's wrappers on the group's tensors
(:mod:`.collective_kernels`); a bf16 activation crosses the all-reduce as
f32 and the all-gather as int32 words, as :mod:`.tp` moves them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import ir
from ..ops.ir import LiftOp, TOp
from ..ops.loops import _HostTape, _sqrt_divisor
from ..ops.shapes import ShapeError
from .mesh import MODEL_AXIS, _full
from .tp import COL, REPL, ROW, _block, _feature_gather, _sum


def _kind(spec) -> str:
    """A weight's form from its spec: row-, column-parallel or
    replicated."""
    spec = _full(spec, 2)
    if spec[0] == MODEL_AXIS:
        return ROW
    return COL if spec[1] == MODEL_AXIS else REPL


@dataclass
class _Layer:
    cell: bool
    params: Tuple[int, ...]    # leaf indices: a cell's (wS, wX, b), an
    #                            ffLayer's (w, b)
    state: Optional[int]       # a cell's state leaf
    kinds: Tuple[str, ...]     # a cell's (wS, wX) forms, an ffLayer's (w,)
    act: TOp                   # the output activation at full width
    act_local: Optional[TOp]   # the same at the block width, when it is
    #                            elementwise and the output row-split
    sact: Optional[TOp]        # a cell's state activation


def chain_layers(rnet, specs, tp: int) -> Optional[List[_Layer]]:
    """The layers of ``rnet`` (a ``gen_net`` chain: its ``arch`` rebuilds
    the same graph) on the leaves' ``specs`` (states, then ``param_specs``)
    over ``tp`` model ranks; None for a graph built another way."""
    from ..backend.numpy_backend import NumpyBackend
    from ..backend.rng import Rng
    from ..models.neuralnet import activation_by_name
    from ..models.recurrent import gen_net

    arch = rnet.arch
    if not arch:
        return None
    try:
        acts = [activation_by_name(a) for a in arch["acts"]]
        sacts = [None if s is None else activation_by_name(s)
                 for s in arch["state_acts"]]
    except (KeyError, ValueError):
        return None
    nb = NumpyBackend()
    ref = gen_net(nb, arch["in"], arch["out"],
                  list(zip(arch["sizes"], acts[:-1], sacts[:-1])), acts[-1],
                  sacts[-1], Rng(nb, 0))
    if ref.op.struct_key() != rnet.op.struct_key():
        return None
    widths = list(arch["sizes"]) + [arch["out"]]
    n_cells = sum(s is not None for s in sacts)
    layers, cursor, cell = [], n_cells, 0
    for o, act, sact in zip(widths, acts, sacts):
        n = 2 if sact is None else 3
        idx = tuple(range(cursor, cursor + n))
        cursor += n
        w_idx = idx[:1] if sact is None else idx[:2]
        kinds = tuple(_kind(specs[i]) for i in w_idx)
        out_split = kinds[0] == ROW and sact is None
        local = None
        op = act(o)
        if out_split and isinstance(op, LiftOp) and op.vf.n_args == 1:
            local = act(o // tp)
        state = None
        if sact is not None:
            state = n_cells - 1 - cell   # states run last cell first
            cell += 1
        layers.append(_Layer(sact is not None, idx, state, kinds, op, local,
                             None if sact is None else sact(o)))
    return layers


class SeqTpNetwork:
    """A ``gen_net`` recurrent chain on one model group: ``devices`` are
    the group's model ranks in order, ``layers`` :func:`chain_layers`'s,
    ``be`` the backend whose dtype the step computes in (``compute``
    overrides it: the bf16 step, its values and gradients upcast to f32
    before the batch mean).

    ``value_and_grad(loss, x, y, ps)`` takes ``(B, n, in)`` sequences and
    their targets on the group's first device and ``ps``, one tuple of the
    leaves (the states, then the params) per model rank (each rank's
    blocks); it returns the mean sequence loss (model rank 0's) and one
    tuple of mean gradients per model rank, each leaf's in its block's
    shape.  ``losses(loss, x, y, ps)`` is each sequence's loss.
    ``remat_every`` and ``offload`` are ``fit_sequences``'
    ``remat_every`` and ``offload_activations`` (the module's docstring)."""

    def __init__(self, layers: Sequence[_Layer],
                 devices: Sequence[torch.device], be,
                 compute: Optional[torch.dtype] = None, remat_every=None,
                 offload: bool = False):
        from ..backend.torch_backend import TorchBackend

        self.layers = list(layers)
        self.n_leaves = 1 + max(i for L in self.layers for i in L.params)
        self.devices = tuple(devices)
        self.tp = len(self.devices)
        self.compute = compute
        self.remat_every = remat_every
        self.offload = bool(offload)
        dtype = compute or be.dtype
        self.bes = [TorchBackend(dtype, d) for d in self.devices]
        self._fns: dict = {}

    # -- the vmapped per-row pieces, one per (op, rank) -----------------
    # the ops are the layers', alive as long as the executor: their ids
    # key the vmapped functions
    def _rows(self, key, make):
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = make()
        return fn

    def _act(self, op: TOp, m: int, z: torch.Tensor) -> torch.Tensor:
        be = self.bes[m]
        fn = self._rows(("f", id(op), m), lambda: torch.func.vmap(
            lambda r: op.apply(be, (r,))[0]))
        return fn(z.reshape(-1, z.shape[-1])).reshape(z.shape)

    def _act_vjp(self, op: TOp, m: int, z: torch.Tensor,
                 ct: torch.Tensor) -> torch.Tensor:
        be = self.bes[m]
        fn = self._rows(("b", id(op), m), lambda: torch.func.vmap(
            lambda r, c: ir.vjp(op, be, (r,), (c,))[0]))
        w = z.shape[-1]
        return fn(z.reshape(-1, w), ct.reshape(-1, w)).reshape(z.shape)

    def _loss(self, loss: TOp, m: int, out, y, grad: bool):
        """Each timestep's loss on rank ``m`` (``(B, n)``) and, with
        ``grad``, its cotangent of the output."""
        be = self.bes[m]
        if grad:
            fn = self._rows(("lg", loss.struct_key(), m), lambda: torch.func
                            .vmap(lambda o, t: ir.value_and_grad(
                                loss, be, (o, t))))
        else:
            fn = self._rows(("l", loss.struct_key(), m), lambda: torch.func
                            .vmap(lambda o, t: loss.apply(be, (o, t))[0]))
        B, n = out.shape[:2]
        res = fn(out.reshape(B * n, -1), y.reshape(B * n, -1))
        if not grad:
            return res.reshape(B, n), None
        return res[0].reshape(B, n), res[1][0].reshape(out.shape)

    # -- the pieces of a layer --------------------------------------------
    def _linear(self, h, split: bool, ws, kind: str):
        """``h . w^T`` on every rank in ``kind``'s form: ``(out, out_split,
        record)``, the record ``(h as used, moved)``."""
        tp = self.tp
        if kind == COL:
            moved = not split
            if moved:
                h = [_block(h[m], m, tp) for m in range(tp)]
            out = _sum([h[m] @ ws[m].T for m in range(tp)])
            return out, False, (h, moved)
        moved = split
        if split:
            h = _feature_gather(h)
        return [h[m] @ ws[m].T for m in range(tp)], kind == ROW, (h, moved)

    def _linear_bwd(self, ct, rec, ws, kind: str, need_in: bool):
        """Per-sequence weight gradients and, with ``need_in``, the input's
        cotangent in the form the input came in."""
        tp = self.tp
        h, moved = rec
        gw = [torch.einsum("bto,bti->boi", ct[m], h[m]) for m in range(tp)]
        if not need_in:
            return gw, None
        cin = [ct[m] @ ws[m] for m in range(tp)]
        if kind == ROW:
            # the whole input: the ranks' partial cotangents summed
            cin = _sum(cin)
        if kind == COL:
            if moved:
                cin = _feature_gather(cin)   # the slice's transpose
        elif moved:
            cin = [_block(cin[m], m, tp) for m in range(tp)]
        return gw, cin

    def _ff(self, L: _Layer, h, split: bool, ps):
        tp = self.tp
        w = [ps[m][L.params[0]] for m in range(tp)]
        b = [ps[m][L.params[1]] for m in range(tp)]
        z, zsplit, rec = self._linear(h, split, w, L.kinds[0])
        z = [z[m] + b[m] for m in range(tp)]
        gathered = zsplit and L.act_local is None
        if gathered:
            z, zsplit = _feature_gather(z), False
        op = L.act_local if zsplit else L.act
        out = [self._act(op, m, z[m]) for m in range(tp)]
        return out, zsplit, (rec, z, zsplit, gathered)

    def _ff_bwd(self, L: _Layer, record, ct, ps, need_in: bool):
        tp = self.tp
        rec, z, zsplit, gathered = record
        op = L.act_local if zsplit else L.act
        cz = [self._act_vjp(op, m, z[m], ct[m]) for m in range(tp)]
        if gathered:
            cz = [_block(cz[m], m, tp) for m in range(tp)]
        w = [ps[m][L.params[0]] for m in range(tp)]
        gw, cin = self._linear_bwd(cz, rec, w, L.kinds[0], need_in)
        grads = {L.params[0]: gw,
                 L.params[1]: [cz[m].sum(1) for m in range(tp)]}
        return grads, cin

    def _block_len(self, n: int) -> Optional[int]:
        """The timesteps of a block whose entry state the backward keeps:
        None keeps every timestep's values (no ``remat_every``, no
        ``offload``), else ``remat_every`` checked as ``ScanOp`` checks it
        (1 without it)."""
        k = self.remat_every
        if k == "sqrt":
            k = _sqrt_divisor(n)
        if k is not None:
            k = int(k)
            if k < 1 or n % k != 0:
                raise ShapeError(
                    f"remat_every ({k}) must be a divisor of the scan "
                    f"length ({n}); pass 'sqrt' to pick the divisor nearest "
                    f"sqrt(n) automatically")
            if k == 1:
                k = None
        if k is None and self.offload:
            k = 1
        return k

    def _steps(self, L: _Layer, u, s, wS, t0: int, t1: int):
        """The cell's timesteps ``t0 .. t1 - 1`` from the state ``s``: the
        state into each, each's whole ``z`` (per rank)."""
        tp = self.tp
        kS = L.kinds[0]
        S, Z = [], []
        for t in range(t0, t1):
            S.append(s)
            if kS == ROW:
                z = _feature_gather([u[m][:, t] + s[m] @ wS[m].T
                                     for m in range(tp)])
            elif kS == COL:
                p = _sum([_block(s[m], m, tp) @ wS[m].T for m in range(tp)])
                z = [u[m][:, t] + p[m] for m in range(tp)]
            else:
                z = [u[m][:, t] + s[m] @ wS[m].T for m in range(tp)]
            Z.append(z)
            s = [self._act(L.sact, m, z[m]) for m in range(tp)]
        return S, Z

    def _stacked(self, per_step):
        return [torch.stack([v[m] for v in per_step], 1)
                for m in range(self.tp)]

    def _cell(self, L: _Layer, h, split: bool, ps, tape: bool = True):
        tp = self.tp
        iS, iX, ib = L.params
        kS, kX = L.kinds
        wS = [ps[m][iS] for m in range(tp)]
        # wX.x + b for every timestep, in wX's output form
        u, usplit, xrec = self._linear(h, split, [ps[m][iX] for m in
                                                  range(tp)], kX)
        u = [u[m] + ps[m][ib] for m in range(tp)]
        moved = None
        if usplit and kS != ROW:
            u, moved = _feature_gather(u), "gathered"
        elif kS == ROW and not usplit:
            u, moved = [_block(u[m], m, tp) for m in range(tp)], "sliced"
        B, n = u[0].shape[:2]
        s = [ps[m][L.state].expand(B, -1) for m in range(tp)]
        S, Z = self._steps(L, u, s, wS, 0, n)
        Zs = self._stacked(Z)
        out = [self._act(L.act, m, Zs[m]) for m in range(tp)]
        k = self._block_len(n) if tape else None
        if k is None:
            return out, False, (xrec, moved, None, (Zs, self._stacked(S)))
        entries = S[::k]
        if self.offload and s[0].is_cuda:
            hosts = [_HostTape(d) for d in self.devices]
            for e in entries:
                for m in range(tp):
                    hosts[m].put((e[m],))
            for ht in hosts:
                ht.seal()

            def entry(j):
                return [hosts[m].slice(j)[0] for m in range(tp)]
        else:
            entry = entries.__getitem__
        return out, False, (xrec, moved, k, (u, entry))

    def _cell_bwd(self, L: _Layer, record, ct, ps, need_in: bool):
        tp = self.tp
        xrec, moved, k, kept = record
        iS, iX, ib = L.params
        kS, kX = L.kinds
        wS = [ps[m][iS] for m in range(tp)]
        n = ct[0].shape[1]
        recompute = k is not None
        k = k or n
        cs, cz, gS = None, [None] * n, None
        # blocks in reverse: every timestep's values kept (one block), or
        # a block's recomputed from its entry state
        for t0 in range(n - k, -1, -k):
            if recompute:
                u, entry = kept
                S, Z = self._steps(L, u, entry(t0 // k), wS, t0, t0 + k)
                Zb, Sb = self._stacked(Z), self._stacked(S)
            else:
                Zb, Sb = kept
            cZ = [self._act_vjp(L.act, m, Zb[m], ct[m][:, t0:t0 + k])
                  for m in range(tp)]
            for t in range(t0 + k - 1, t0 - 1, -1):
                c = [cZ[m][:, t - t0] for m in range(tp)]
                if cs is not None:
                    c = [c[m] + self._act_vjp(L.sact, m, Zb[m][:, t - t0],
                                              cs[m]) for m in range(tp)]
                if kS == ROW:
                    # the gather's transpose, then the whole state's
                    # cotangent: the ranks' partial cotangents summed
                    c = [_block(c[m], m, tp) for m in range(tp)]
                    cs = _sum([c[m] @ wS[m] for m in range(tp)])
                elif kS == COL:
                    cs = _feature_gather([c[m] @ wS[m] for m in range(tp)])
                else:
                    cs = [c[m] @ wS[m] for m in range(tp)]
                cz[t] = c
            czb = self._stacked(cz[t0:t0 + k])
            Sk = ([_block(Sb[m], m, tp) for m in range(tp)] if kS == COL
                  else Sb)
            g = [torch.einsum("bto,bti->boi", czb[m], Sk[m])
                 for m in range(tp)]
            gS = g if gS is None else [gS[m] + g[m] for m in range(tp)]
        cz = self._stacked(cz)
        if moved == "gathered":
            cz = [_block(cz[m], m, tp) for m in range(tp)]
        elif moved == "sliced":
            cz = _feature_gather(cz)
        wX = [ps[m][iX] for m in range(tp)]
        gX, cin = self._linear_bwd(cz, xrec, wX, kX, need_in)
        grads = {iS: gS, iX: gX, ib: [cz[m].sum(1) for m in range(tp)],
                 L.state: cs}
        return grads, cin

    # -- the chain ----------------------------------------------------------
    def _cast(self, x, y, ps):
        c = self.compute
        if not c:
            return x, y, ps
        return x.to(c), y.to(c), [tuple(p.to(c) for p in pm) for pm in ps]

    def _forward(self, x, ps, tape: bool = True):
        h = [x.to(d) for d in self.devices]
        split, records = False, []
        for L in self.layers:
            h, split, rec = (self._cell(L, h, split, ps, tape) if L.cell
                             else self._ff(L, h, split, ps))
            records.append(rec)
        if split:
            h = _feature_gather(h)
        return h, records, split

    def losses(self, loss: TOp, x, y, ps) -> torch.Tensor:
        """Each sequence's loss (the sum over its timesteps), on the
        group's first device."""
        x, y, ps = self._cast(x, y, ps)
        out, _, _ = self._forward(x, ps, tape=False)
        v, _ = self._loss(loss, 0, out[0], y.to(self.devices[0]), False)
        return v.sum(1)

    def value_and_grad(self, loss: TOp, x, y, ps):
        tp = self.tp
        x, y, ps = self._cast(x, y, ps)
        out, records, split = self._forward(x, ps)
        lv = [self._loss(loss, m, out[m], y.to(self.devices[m]), True)
              for m in range(tp)]
        ct = [g for _, g in lv]
        if split:
            ct = [_block(ct[m], m, tp) for m in range(tp)]
        grads = [[None] * self.n_leaves for _ in range(tp)]
        for j in range(len(self.layers) - 1, -1, -1):
            L = self.layers[j]
            bwd = self._cell_bwd if L.cell else self._ff_bwd
            per, ct = bwd(L, records[j], ct, ps, j > 0)
            for i, gs in per.items():
                for m in range(tp):
                    grads[m][i] = gs[m]
        v = lv[0][0].sum(1)
        if self.compute:
            v = v.float()
            grads = [[g.float() for g in gm] for gm in grads]
        return v.mean(), [tuple(g.mean(dim=0) for g in gm) for gm in grads]
