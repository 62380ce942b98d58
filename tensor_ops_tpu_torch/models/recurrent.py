"""Recurrent networks (BPTT) — rebuild of
``src/TensorOps/Learn/NeuralNet/Recurrent.hs``.

A :class:`RecurrentNetwork` holds one *step* op
``([i] : ss ++ ps) -> ([o] : ss)`` (``Recurrent.hs:69-75``), its current
state tensors, and its parameters.  Sequence training drives the step with
:class:`~tensor_ops_tpu_torch.ops.loops.ScanOp` — a loop over the timesteps
with a reversed-loop backward — instead of the reference's compile-time
graph unrolling (``unroll``/``rollup``, ``Recurrent.hs:392-463``), fixing
its O(n^2) gradient cost while computing the same values: the sequence loss
is the *sum of per-step losses* and parameters are shared across steps.
Dual learning rates (state vs params) follow ``trainNetwork'``
(``Recurrent.hs:326-354``).  Batched-sequence training maps the gradient
over the batch with ``torch.func.vmap``, as ``models/training.py`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .. import engine
from ..backend.base import Backend, normal
from ..backend.rng import Rng
from ..ops import ir
from ..ops import prim as P
from ..ops.ir import TOp, First, Shuffle
from ..ops.loops import MappedOp, ScanOp
from ..ops.shapes import ShapeError
from .feedforward import Network
from .neuralnet import Activation


@dataclass
class RecurrentNetwork:
    """``Network t i o`` with state (``Recurrent.hs:69-75``)."""

    op: TOp                    # step: ([i] : ss ++ ps) -> ([o] : ss)
    states: Tuple[Any, ...]    # current state tensors (ss)
    params: Tuple[Any, ...]    # parameters (ps)
    arch: Optional[dict] = None  # set by gen_net ({sizes, acts,
    # state_acts, in, out}); travels with checkpoints so serving can
    # rebuild the graph without out-of-band flags

    def __post_init__(self):
        self.states = tuple(self.states)
        self.params = tuple(self.params)
        k = len(self.states)
        if len(self.op.out_stack) != 1 + k:
            raise ShapeError("recurrent op must output [y] + states")
        if len(self.op.in_stack) != 1 + k + len(self.params):
            raise ShapeError("recurrent op inputs must be [x] + states + params")
        if self.op.in_stack[1 : 1 + k] != self.op.out_stack[1:]:
            raise ShapeError("recurrent op state shapes must thread through")

    @property
    def in_shape(self):
        return self.op.in_stack[0]

    @property
    def out_shape(self):
        return self.op.out_stack[0]

    @property
    def state_stack(self):
        return self.op.out_stack[1:]

    @property
    def param_stack(self):
        return self.op.in_stack[1 + len(self.states):]

    # -- running (Recurrent.hs:226-241) ---------------------------------
    def run(self, be: Backend, x: Any) -> Tuple[Any, "RecurrentNetwork"]:
        """One step; returns (output, network with updated state)
        (``runNetwork``)."""
        fn = engine.compile_run(self.op, be)
        outs = fn(x, *self.states, *self.params)
        return outs[0], RecurrentNetwork(self.op, tuple(outs[1:]),
                                         self.params, self.arch)

    def run_seq(self, be: Backend, xs: Any) -> Tuple[Any, "RecurrentNetwork"]:
        """Run a whole ``(n, *in_shape)`` sequence through one scan;
        returns ``(ys of shape (n, *out_shape), network with the final
        states)`` — ``runNetwork`` folded over the sequence."""
        n = int(be.shape_of(xs)[0])
        fn = engine.compile_run(seq_scan_op(self.op, n, len(self.states)), be)
        outs = fn(xs, *self.states, *self.params)
        return outs[0], RecurrentNetwork(self.op, tuple(outs[1:]),
                                         self.params, self.arch)

    # -- composition (Recurrent.hs:176-224, 243-263) ---------------------
    def then(self, other: "RecurrentNetwork") -> "RecurrentNetwork":
        """``net1 ~*~ net2``: result state stack is ``ss2 ++ ss1`` and
        params ``ps1 ++ ps2``, exactly as the reference's swap'-plumbed
        composition (``Recurrent.hs:176-224``)."""
        if self.out_shape != other.in_shape:
            raise ShapeError("recurrent compose: shape mismatch")
        a = (self.in_shape,)
        ss1, ps1 = self.state_stack, self.param_stack
        ss2, ps2 = other.state_stack, other.param_stack
        k1, k2, p1n, p2n = len(ss1), len(ss2), len(ps1), len(ps2)

        # input: [a] ss2 ss1 ps1 ps2  ->  [a] ss1 ps1 ss2 ps2
        in_stack = a + ss2 + ss1 + ps1 + ps2
        idx = (
            (0,)
            + tuple(range(1 + k2, 1 + k2 + k1 + p1n))        # ss1 ps1
            + tuple(range(1, 1 + k2))                        # ss2
            + tuple(range(1 + k2 + k1 + p1n, len(in_stack)))  # ps2
        )
        rearrange = Shuffle(in_stack, idx)
        # run o1 on [a] ss1 ps1, pass ss2 ps2 through
        step1 = First(self.op, rest=ss2 + ps2)
        # now: [b] ss1 ss2 ps2  ->  [b] ss2 ps2 ss1
        mid = (self.out_shape,) + ss1 + ss2 + ps2
        idx2 = (
            (0,)
            + tuple(range(1 + k1, 1 + k1 + k2 + p2n))        # ss2 ps2
            + tuple(range(1, 1 + k1))                        # ss1
        )
        rearrange2 = Shuffle(mid, idx2)
        # run o2 on [b] ss2 ps2, pass ss1 through -> [c] ss2 ss1
        step2 = First(other.op, rest=ss1)
        op = rearrange >> step1 >> rearrange2 >> step2
        return RecurrentNetwork(
            op, other.states + self.states, self.params + other.params
        )

    def pre_op(self, f: TOp) -> "RecurrentNetwork":
        """``f ~* net`` (``Recurrent.hs:243-248``)."""
        # graph-altering composition invalidates the gen_net arch: a
        # checkpoint->serve rebuild from it would silently omit ``f``
        return RecurrentNetwork(f.lead(self.op), self.states, self.params)

    def post_op(self, f: TOp) -> "RecurrentNetwork":
        """``net *~ f`` — applies to the output only, not the state
        (``Recurrent.hs:250-255``)."""
        return RecurrentNetwork(
            self.op >> First(f, rest=self.state_stack), self.states,
            self.params  # arch dropped: the rebuilt graph would omit f
        )

    def nmap(self, f: Callable) -> "RecurrentNetwork":
        return self.post_op(P.map_op(self.out_shape, f))

    # -- sequence gradients & training ------------------------------------
    def _seq_graph(self, loss: TOp, n: int, remat_every=None,
                   offload_tape: bool = False) -> TOp:
        """(xs, ss, ps, targets) -> scalar: scan the step op over n steps,
        pair each output with its target through ``loss``, and sum —
        semantically the reference's ``unroll >>> rollup``
        (``Recurrent.hs:296-308``) built on ScanOp/MappedOp.
        ``remat_every`` checkpoints the scan's backward carries
        (``ScanOp``) for long sequences; ``offload_tape`` streams them
        through pinned host memory (see :class:`ScanOp`)."""
        key = ("seq", loss.struct_key(), n, remat_every, offload_tape)
        g = self.op._compiled.get(key)
        if g is not None:
            return g
        k = len(self.states)
        scan = seq_scan_op(self.op, n, k, remat_every, offload_tape)
        tgt_shape = (n,) + self.out_shape
        after = scan.out_stack + (tgt_shape,)          # ys, ss_final, tgts
        pick = Shuffle(after, (0, len(after) - 1))     # ys, tgts (final states dropped)
        g = (
            First(scan, rest=[tgt_shape])
            >> pick
            >> MappedOp(loss, n)
            >> P.sum_rows((n,))
        )
        self.op._compiled[key] = g
        return g

    def seq_grad(
        self, loss: TOp, be: Backend, xs: Any, targets: Any
    ) -> Tuple[Any, Tuple[Any, ...], Tuple[Any, ...]]:
        """Gradients of the summed sequence loss w.r.t. (inputs, initial
        states, params) (``netGrad``, ``Recurrent.hs:265-324``)."""
        n = int(be.shape_of(xs)[0])
        g = self._seq_graph(loss, n)
        fn = engine.compile_grad(g, be)
        grads = fn(xs, *self.states, *self.params, targets)
        k = len(self.states)
        return grads[0], tuple(grads[1 : 1 + k]), tuple(grads[1 + k : -1])

    def seq_loss(self, loss: TOp, be: Backend, xs: Any, targets: Any) -> Any:
        n = int(be.shape_of(xs)[0])
        g = self._seq_graph(loss, n)
        return engine.compile_run(g, be)(xs, *self.states, *self.params, targets)[0]

    def train(
        self,
        loss: TOp,
        rate_state: float,
        rate_param: float,
        be: Backend,
        xs: Any,
        targets: Any,
    ) -> "RecurrentNetwork":
        """One SGD step with separate state/param learning rates
        (``trainNetwork'``, ``Recurrent.hs:326-354``)."""
        _, gS, gP = self.seq_grad(loss, be, xs, targets)
        new_s = tuple(s - rate_state * g for s, g in zip(self.states, gS))
        new_p = tuple(p - rate_param * g for p, g in zip(self.params, gP))
        return RecurrentNetwork(self.op, new_s, new_p, self.arch)

    def train_batch(
        self,
        loss: TOp,
        rate_state: float,
        rate_param: float,
        be: Backend,
        xs_batch: Any,
        targets_batch: Any,
    ) -> "RecurrentNetwork":
        """Batched-sequence SGD (rebuild extra — the reference trains one
        sequence at a time): ``torch.func.vmap`` of the scan-BPTT gradient
        over a leading batch axis of ``(B, n, *in_shape)`` inputs, the
        gradients meaned over the batch."""
        n = int(be.shape_of(xs_batch)[1])
        g = self._seq_graph(loss, n)
        k = len(self.states)
        key = ("seq_batch", loss.struct_key(), n) + be.cache_key()
        fn = self.op._compiled.get(key)
        if fn is None:

            def one(xs, tgt, *sp):
                grads = ir.grad(g, be, (xs,) + sp + (tgt,))
                return grads[1:-1]  # state+param grads

            vmapped = torch.func.vmap(
                one, in_dims=(0, 0) + (None,) * (k + len(self.params)))

            def fn(rs, rp, xb, tb, states, params):
                grads = vmapped(xb, tb, *states, *params)
                gS = tuple(gr.mean(dim=0) for gr in grads[:k])
                gP = tuple(gr.mean(dim=0) for gr in grads[k:])
                return (
                    tuple(s - rs * gg for s, gg in zip(states, gS)),
                    tuple(p - rp * gg for p, gg in zip(params, gP)),
                )

            self.op._compiled[key] = fn
        new_s, new_p = fn(rate_state, rate_param, xs_batch, targets_batch,
                          self.states, self.params)
        return RecurrentNetwork(self.op, tuple(new_s), tuple(new_p),
                                self.arch)


def seq_scan_op(op: TOp, n: int, n_state: int, remat_every=None,
                offload_tape: bool = False):
    """The cached length-``n`` ScanOp over a recurrent step op — the one
    construction (and cache-key convention) shared by the training seq
    graph (``_seq_graph``), ``run_seq`` and the serving
    ``SequencePredictor``, so the scan is built once per (op, n).
    ``remat_every`` checkpoints the backward's carries (see
    :class:`~tensor_ops_tpu_torch.ops.loops.ScanOp`); ``offload_tape``
    streams the taped carries through pinned host memory."""
    key = ("seq_scan", n, n_state, remat_every, offload_tape)
    scan = op._compiled.get(key)
    if scan is None:
        scan = ScanOp(op, n, n_state, remat_every=remat_every,
                      offload_tape=offload_tape)
        op._compiled[key] = scan
    return scan


def stateless(ff: Network) -> RecurrentNetwork:
    """Embed a feed-forward network as a stateless recurrent one
    (``stateless``, ``Recurrent.hs:132-137``)."""
    return RecurrentNetwork(ff.op, (), ff.params)


def ff_layer(be: Backend, i: int, o: int, rng: Rng) -> RecurrentNetwork:
    """``Recurrent.ffLayer`` (``Recurrent.hs:139-144``)."""
    from .feedforward import ff_layer as ff

    return stateless(ff(be, i, o, rng))


def fully_connected(
    act: Activation, be: Backend, i: int, o: int, rng: Rng
) -> RecurrentNetwork:
    """Elman-style fully connected recurrent layer: pre-activation
    ``z = Ws.s + Wx.x + b`` is the *output*, the new state is ``act(z)``
    (``fullyConnected``, ``Recurrent.hs:97-125``).  Params ``(wS, wX,
    b)``."""
    s0 = be.asarray(rng.draw(normal(0.0, 0.5), (o,)))
    wS = be.asarray(rng.draw(normal(0.0, 0.5), (o, o)))
    wX = be.asarray(rng.draw(normal(0.0, 0.5), (o, i)))
    b = be.asarray(rng.draw(normal(0.0, 0.5), (o,)))
    sh_i, sh_o = (i,), (o,)
    # stack: [x, s, wS, wX, b]
    op = (
        P.second(
            P.first(P.swap(sh_o, (o, o)) >> P.mat_vec(o, o), rest=[(o, i), sh_o])
            >> P.first(P.swap(sh_o, (o, i)), rest=[sh_o]),
            front=[sh_i],
        )                                     # [x, wX, wS.s, b]
        >> P.first(P.swap(sh_i, (o, i)) >> P.mat_vec(o, i), rest=[sh_o, sh_o])
        >> P.add3(sh_o)                       # [z]
        >> P.duplicate(sh_o)                  # [z, z]
        >> P.second(act(o), front=[sh_o])     # [z, act(z)]
    )
    return RecurrentNetwork(op, (s0,), (wS, wX, b))


def gen_net(
    be: Backend,
    i: int,
    o: int,
    hidden: Sequence[Tuple[int, Activation, Optional[Activation]]],
    act_out: Activation,
    state_act_out: Optional[Activation],
    rng: Rng,
) -> RecurrentNetwork:
    """Recurrent ``genNet`` (``Recurrent.hs:146-170``): each entry is
    (size, output activation, state activation or None); None means a
    stateless ffLayer at that position."""
    sizes = [i] + [h for h, _, _ in hidden] + [o]
    acts = [a for _, a, _ in hidden] + [act_out]
    sacts = [s for _, _, s in hidden] + [state_act_out]
    net: Optional[RecurrentNetwork] = None
    for k in range(len(sizes) - 1):
        if sacts[k] is None:
            layer = ff_layer(be, sizes[k], sizes[k + 1], rng)
        else:
            layer = fully_connected(sacts[k], be, sizes[k], sizes[k + 1], rng)
        layer = layer.post_op(acts[k](sizes[k + 1]))
        net = layer if net is None else net.then(layer)
    if net is None:
        raise ShapeError("recurrent gen_net needs at least one layer")
    # architecture metadata: enough to rebuild this exact graph
    # (checkpoint meta -> serve CLI, no out-of-band flags needed)
    net.arch = {
        "in": i, "out": o, "sizes": [h for h, _, _ in hidden],
        "acts": [a.name for a in acts],
        "state_acts": [s.name if s is not None else None for s in sacts],
    }
    return net
