"""Structured-loop IR nodes: ``ScanOp`` (recurrence over a time axis),
``MappedOp`` (an op mapped over a leading axis) and ``Remat``
(rematerialization).

The reference unrolls BPTT at compile time (``unroll``/``rollup``,
``src/TensorOps/Learn/NeuralNet/Recurrent.hs:392-463``): an O(n)-size graph
per sequence length whose composition recomputes forwards inside backwards,
O(n^2) in all (SURVEY.md §3.4).  Here the step op is one graph node driven
by a Python loop over the timesteps; the backward is a reversed loop that
recomputes each step's forward from its saved carry (O(n) work, O(n*state)
memory: the checkpointed-RNN recipe).  The JAX package runs the same loops
as ``jax.lax.scan``.

Every loop here is written so that it runs under ``torch.func.vmap``
(``SequencePredictor`` and ``RecurrentNetwork.train_batch`` map it over a
batch of sequences): no in-place updates, no ``.item()``, no numpy and no
Python branching on tensor values.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .ir import TOp
from .shapes import ShapeError, fmt_stack


def _sqrt_divisor(n: int) -> int:
    """The divisor of ``n`` nearest sqrt(n): the block size minimizing the
    checkpointed scan's O(n/k + k) residual state."""
    best, target = 1, n ** 0.5
    for d in range(1, int(n ** 0.5) + 1):
        if n % d == 0:
            for cand in (d, n // d):
                if abs(cand - target) < abs(best - target):
                    best = cand
    return best


class _HostTape:
    """Taped carries streamed to pinned host memory (``offload_tape`` on a
    CUDA tensor).  Each carry is copied device-to-host with
    ``non_blocking=True`` on a side stream as it is taped; the event recorded
    after the last copy is what the backward's stream waits on before it
    copies a slice back (:meth:`slice`)."""

    __slots__ = ("device", "stream", "slices", "event")

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slices = []
        self.event = None

    def put(self, carry: Tuple[torch.Tensor, ...]) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)  # the carry has been written
        with torch.cuda.stream(self.stream):
            # a non-blocking copy to the CPU lands in pinned memory
            self.slices.append(tuple(c.to("cpu", non_blocking=True)
                                     for c in carry))
        for c in carry:
            # the carry's memory is not reused before the copy has read it
            c.record_stream(self.stream)

    def seal(self) -> None:
        self.event = torch.cuda.Event()
        self.event.record(self.stream)

    def slice(self, j: int) -> Tuple[torch.Tensor, ...]:
        torch.cuda.current_stream(self.device).wait_event(self.event)
        return tuple(h.to(self.device, non_blocking=True)
                     for h in self.slices[j])


class ScanOp(TOp):
    """Run ``step`` — a TOp ``([x] : ss ++ ps) -> ([y] : ss)`` — over a
    stacked time axis.

    Stacks::

        in :  [(n, *x_shape)] ++ ss ++ ps
        out:  [(n, *y_shape)] ++ ss        (final states)

    Inputs are time-major stacked tensors (index 0 = first step), unlike
    the reference's one-stack-slot-per-step unroll with reversed input
    order (``Recurrent.hs:392-431``); gradients are verified equal to the
    unrolled-graph semantics in tests.

    ``remat_every=k`` checkpoints the scan: only every k-th carry is taped
    and the backward recomputes the intervening forwards block by block,
    dropping residual state from O(n·state) to O((n/k + k)·state).
    ``remat_every="sqrt"`` picks the divisor of ``n`` nearest sqrt(n).
    Gradients are bit-identical to the plain scan (the same ops run in the
    same order, just recomputed).

    ``offload_tape=True`` streams the taped carries through pinned host
    memory when they lie on a CUDA device: each is copied to the host with
    ``non_blocking=True`` on a side stream as the forward writes it, and the
    backward copies each back right before use, after its stream has waited
    on the copies' event.  The scan's residual device memory drops to
    O(state).  Gradients are bit-identical: placement changes nothing
    numerically.  On CPU tensors it changes nothing.  Composes with
    ``remat_every`` (only the block-entry carries travel).  The offloaded
    tape is for a scan run outside ``torch.func.vmap``."""

    __slots__ = ("step", "n", "n_state", "remat_every", "offload_tape")

    def __init__(self, step: TOp, n: int, n_state: int, remat_every=None,
                 offload_tape: bool = False):
        if n < 1:
            raise ShapeError("scan needs n >= 1 steps")
        if remat_every == "sqrt":
            remat_every = _sqrt_divisor(n)
        if remat_every is not None:
            remat_every = int(remat_every)
            if remat_every < 1 or n % remat_every != 0:
                raise ShapeError(
                    f"remat_every ({remat_every}) must be a divisor of the "
                    f"scan length ({n}); pass 'sqrt' to pick the divisor "
                    f"nearest sqrt(n) automatically")
            if remat_every == 1:
                remat_every = None  # every carry saved == the plain scan
        self.remat_every = remat_every
        self.offload_tape = bool(offload_tape)
        if len(step.out_stack) != 1 + n_state:
            raise ShapeError(
                f"scan step must output [y] + {n_state} states, got "
                f"{fmt_stack(step.out_stack)}"
            )
        if step.in_stack[1 : 1 + n_state] != step.out_stack[1:]:
            raise ShapeError(
                "scan step state shapes must match between input "
                f"{fmt_stack(step.in_stack)} and output {fmt_stack(step.out_stack)}"
            )
        self.step = step
        self.n = int(n)
        self.n_state = int(n_state)
        x_shape = step.in_stack[0]
        y_shape = step.out_stack[0]
        ss = step.out_stack[1:]
        ps = step.in_stack[1 + n_state :]
        super().__init__(
            ((self.n,) + x_shape,) + ss + ps,
            ((self.n,) + y_shape,) + ss,
        )

    def _skey_parts(self):
        return (self.step.struct_key(), self.n, self.n_state,
                self.remat_every, self.offload_tape)

    def _split(self, xs):
        k = self.n_state
        return xs[0], tuple(xs[1 : 1 + k]), tuple(xs[1 + k :])

    def _host_tape(self, xarr) -> Any:
        if self.offload_tape and xarr.is_cuda:
            return _HostTape(xarr.device)
        return None

    def apply_tape(self, be, xs, with_tape=True):
        xarr, s0, params = self._split(xs)
        k = self.remat_every
        host = self._host_tape(xarr) if with_tape else None
        s = s0
        ys, s_ins = [], []
        for t in range(self.n):
            if with_tape and (k is None or t % k == 0):
                # the carry INTO step t: every one, or each block's entry
                if host is not None:
                    host.put(s)
                else:
                    s_ins.append(s)
            outs = self.step.apply(be, (xarr[t],) + s + params)
            ys.append(outs[0])
            s = tuple(outs[1:])
        out = (torch.stack(ys),) + s
        if not with_tape:
            return out, None
        if host is not None:
            host.seal()
            return out, (xarr, host, params)
        stacked = tuple(torch.stack([si[j] for si in s_ins])
                        for j in range(self.n_state))
        return out, (xarr, stacked, params)

    def transpose(self, be, tape, cts):
        xarr, s_ins, params = tape
        y_cts, s_ct = cts[0], tuple(cts[1 : 1 + self.n_state])
        if isinstance(s_ins, _HostTape):
            carry_in = s_ins.slice
        else:
            def carry_in(j):
                return tuple(si[j] for si in s_ins)

        def backstep(s_ct, t, s_in):
            """One reverse step: recompute the forward from the saved
            carry, transpose, and split the input cotangents."""
            _, step_tape = self.step.apply_tape(be, (xarr[t],) + s_in + params)
            in_cts = self.step.transpose(be, step_tape, (y_cts[t],) + s_ct)
            return (tuple(in_cts[1 : 1 + self.n_state]), in_cts[0],
                    tuple(in_cts[1 + self.n_state :]))

        p_acc = tuple(torch.zeros_like(p) for p in params)
        dxs = [None] * self.n
        k = self.remat_every or 1
        # blocks in reverse; inside a block, re-run its forward from the
        # block-entry carry to recover the per-step carries, then reverse
        # (with no checkpointing every block is one step long)
        for bidx in range(self.n // k - 1, -1, -1):
            t0 = bidx * k
            s = carry_in(bidx)
            block = [s]
            for t in range(t0, t0 + k - 1):
                s = tuple(self.step.apply(be, (xarr[t],) + s + params)[1:])
                block.append(s)
            for t in range(t0 + k - 1, t0 - 1, -1):
                s_ct, dxs[t], dp = backstep(s_ct, t, block[t - t0])
                p_acc = tuple(a + d for a, d in zip(p_acc, dp))
        return (torch.stack(dxs),) + s_ct + p_acc


class MappedOp(TOp):
    """Map an op over a new leading axis of size ``n`` on every input and
    output slot — the staged analog of the reference's per-slice
    ``mapRows`` (``src/TensorOps/Types.hs:77-81``), and the IR-native way
    to express batching.  The forward is ``torch.func.vmap`` of the op.
    ``torch.func.vmap`` returns tensors only, so the tape keeps the inputs
    and the transpose maps the op's own forward and transpose over the rows
    (the same ops on the same values: gradients are those of a per-row
    tape)."""

    __slots__ = ("op", "n")

    def __init__(self, op: TOp, n: int):
        self.op = op
        self.n = int(n)
        super().__init__(
            tuple((self.n,) + s for s in op.in_stack),
            tuple((self.n,) + s for s in op.out_stack),
        )

    def _skey_parts(self):
        return (self.op.struct_key(), self.n)

    def apply_tape(self, be, xs, with_tape=True):
        ys = torch.func.vmap(lambda *row: self.op.apply(be, row))(*xs)
        return tuple(ys), (tuple(xs) if with_tape else None)

    def transpose(self, be, tape, cts):
        k = len(self.op.in_stack)

        def row_vjp(*row):
            _, t = self.op.apply_tape(be, row[:k], True)
            return self.op.transpose(be, t, row[k:])

        return tuple(torch.func.vmap(row_vjp)(*tape, *cts))


class Remat(TOp):
    """Rematerialization wrapper: store only the wrapped op's *inputs* on
    the tape and recompute its forward inside the backward pass, trading
    FLOPs for residual memory.  Gradients are identical to the unwrapped
    op."""

    __slots__ = ("op",)

    def __init__(self, op: TOp):
        self.op = op
        super().__init__(op.in_stack, op.out_stack)

    def _skey_parts(self):
        return (self.op.struct_key(),)

    def apply_tape(self, be, xs, with_tape=True):
        ys, _ = self.op.apply_tape(be, xs, with_tape=False)
        return ys, (xs if with_tape else None)

    def transpose(self, be, tape, cts):
        _, inner_tape = self.op.apply_tape(be, tape, with_tape=True)
        return self.op.transpose(be, inner_tape, cts)
