"""Batched training: the upgrade over the reference's strictly per-sample
SGD hot loop (``trainAll = foldl' trainNetwork``, ``app/MNIST.hs:390-396``).

The staged per-sample graph is mapped over the batch axis with
``torch.func.vmap`` (params broadcast) and the per-sample gradients are
averaged, so the card sees ``[B, i] x [o, i]`` products instead of rank-1
chains.  The AD is still the framework's own graph transposition (vmap maps
over it); ``torch.autograd`` is never used on the model.  The entry points
the JAX package jits (``batched_run``, ``batched_step``, ``train_fold``,
``batch_loss``, ``seq_losses``) are compiled (``engine.maybe_jit``,
``engine.Loop``): on the card one CUDA graph per shape, the fold one
per-sample step replayed once a sample.  On the NumPy oracle
(``NumpyBackend``) each function loops over the samples, as the JAX
package's numpy branches do.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .. import engine
from ..backend.base import Backend
from ..ops import ir
from ..ops.ir import TOp
from .feedforward import Network


def _cache(net: Network, key, build):
    fn = net.op._compiled.get(key)
    if fn is None:
        fn = build()
        net.op._compiled[key] = fn
    return fn


def _vmap(fn: Callable, n_batched: int, n_params: int) -> Callable:
    return torch.func.vmap(fn, in_dims=(0,) * n_batched + (None,) * n_params)


def make_vmapped_grads(net: Network, loss: TOp, be: Backend) -> Callable:
    """The shared core of every batched trainer: the per-sample staged
    graph's value and gradient (transposition AD), vmapped over the batch
    with params broadcast.  Returns ``fn(xb, yb, *params) -> (per-sample
    losses, per-sample param grads)``."""
    composed = net._loss_op(loss)

    def sample_vag(x, y, *params):
        v, grads = ir.value_and_grad(composed, be, (x,) + params + (y,))
        return v, grads[1:-1]

    return _vmap(sample_vag, 2, len(net.params))


def make_mean_grads(net: Network, loss: TOp, be: Backend) -> Callable:
    """``fn(xb, yb, *params) -> (mean loss, mean param grads)`` over a
    batch: :func:`make_vmapped_grads` and its batch mean, or on the NumPy
    oracle a loop over the samples that sums their gradients (the JAX
    package's numpy branch; nothing of batch size is stacked)."""
    if be.name == "numpy":
        composed = net._loss_op(loss)

        def loop(xb, yb, *params):
            vals = []
            sums = [np.zeros_like(p) for p in params]
            for x, y in zip(xb, yb):
                v, grads = ir.value_and_grad(composed, be,
                                             (x,) + params + (y,))
                vals.append(v)
                for acc, g in zip(sums, grads[1:-1]):
                    acc += g
            return float(np.mean(vals)), tuple(s / len(xb) for s in sums)

        return loop

    vmapped = make_vmapped_grads(net, loss, be)

    def mean(xb, yb, *params):
        vals, grads = vmapped(xb, yb, *params)
        return vals.mean(), tuple(g.mean(dim=0) for g in grads)

    return mean


def make_seq_mean_grads(rnet, loss: TOp, be: Backend, n: int,
                        remat_every=None, offload_tape: bool = False,
                        upcast: Optional[torch.dtype] = None) -> Callable:
    """``fn(xb, tb, leaves) -> (mean loss, mean grads)`` over a batch of
    ``(B, n, *in)`` sequences, ``leaves`` the states then the params and
    the grads in that order: the scan-BPTT sequence graph's value and
    gradient (``rnet._seq_graph``), vmapped over the sequences with the
    leaves broadcast, and its batch mean; on the NumPy oracle a loop over
    the sequences that sums their gradients (the JAX package's numpy
    branch).  ``upcast`` casts the per-sequence values and gradients to
    that dtype BEFORE the mean (the bf16 step's f32 mean).  Cached on the
    step op.  ``RecurrentNetwork.train_batch`` and ``fit_sequences`` step
    on it."""
    key = ("seq_mean_grads", loss.struct_key(), n, remat_every,
           offload_tape, upcast) + be.cache_key()

    def build():
        g = rnet._seq_graph(loss, n, remat_every=remat_every,
                            offload_tape=offload_tape)
        if be.name == "numpy":
            def loop(xb, tb, leaves):
                sums = [np.zeros_like(x) for x in leaves]
                vals = []
                for x, t in zip(xb, tb):
                    v, grads = ir.value_and_grad(g, be,
                                                 (x,) + tuple(leaves) + (t,))
                    vals.append(float(np.asarray(v)))
                    for acc, gg in zip(sums, grads[1:-1]):
                        acc += gg
                return (float(np.mean(vals)),
                        tuple(s / len(xb) for s in sums))

            return loop

        def one(xs, tgt, *sp):
            v, grads = ir.value_and_grad(g, be, (xs,) + sp + (tgt,))
            return v, grads[1:-1]

        vmapped = _vmap(one, 2, len(rnet.states) + len(rnet.params))

        def mean(xb, tb, leaves):
            vals, grads = vmapped(xb, tb, *leaves)
            if upcast is not None:
                vals = vals.to(upcast)
                grads = tuple(gr.to(upcast) for gr in grads)
            return vals.mean(), tuple(gr.mean(dim=0) for gr in grads)

        return mean

    return _cache(rnet, key, build)


def batched_run(net: Network, be: Backend) -> Callable:
    """Batched inference ``fn(xb, *params) -> yb``."""
    key = ("brun",) + be.cache_key()

    def build():
        if be.name == "numpy":
            def loop(xb, *params):
                return np.stack([net.op.apply(be, (x,) + tuple(params))[0]
                                 for x in xb])

            return loop

        def single(x, *params):
            return net.op.apply(be, (x,) + params)[0]

        return engine.maybe_jit(_vmap(single, 1, len(net.params)), be,
                                "batched_run")

    return _cache(net, key, build)


def batched_step(net: Network, loss: TOp, be: Backend) -> Callable:
    """Minibatch SGD step ``fn(rate, xb, yb, *params) -> (mean_loss,
    new_params)``: per-sample transposition AD, vmapped, mean-reduced."""
    key = ("bstep", loss.struct_key()) + be.cache_key()

    def build():
        mean_grads = make_mean_grads(net, loss, be)

        def step(rate, xb, yb, *params):
            v, grads = mean_grads(xb, yb, *params)
            return v, tuple(p - rate * g for p, g in zip(params, grads))

        return engine.maybe_jit(step, be, "the minibatch step")

    return _cache(net, key, build)


def train_fold(net: Network, loss: TOp, be: Backend, rate: float, X: Any,
               Y: Any) -> Network:
    """The reference's per-sample SGD fold (``trainAll = foldl'
    trainNetwork``, ``app/MNIST.hs:390-396``), the same steps as calling
    :meth:`Network.train` per sample: an ``engine.Loop`` over the samples
    carrying the parameters, on the card ONE captured per-sample step
    replayed once a sample (the JAX package's one ``lax.scan``), elsewhere
    a Python loop."""
    key = ("fold", loss.struct_key()) + be.cache_key()

    def build():
        composed = net._loss_op(loss)

        def body(i, params, rate, X, Y):
            x, y = engine.take(X, i), engine.take(Y, i)
            grads = ir.grad(composed, be, (x,) + params + (y,))
            return tuple(p - rate * g for p, g in zip(params, grads[1:-1]))

        return engine.Loop(body, "the per-sample fold's step")

    params = _cache(net, key, build)(len(X), tuple(net.params), rate, X, Y)
    return Network(net.op, params, net.act_names)


def train_minibatch(net: Network, loss: TOp, be: Backend, rate: float,
                    xb: Any, yb: Any) -> Tuple[Any, Network]:
    """One minibatch SGD step; returns (mean loss, updated network)."""
    step = batched_step(net, loss, be)
    v, new_params = step(rate, xb, yb, *net.params)
    return v, Network(net.op, new_params, net.act_names)


def _predictions(net: Network, be: Backend, xb: Any) -> np.ndarray:
    out = batched_run(net, be)(be.asarray(xb), *net.params)
    if isinstance(out, np.ndarray):
        return out.argmax(axis=1)
    return out.argmax(dim=1).cpu().numpy()


def accuracy(net: Network, be: Backend, xb: Any, yb_idx: Any) -> float:
    """Fraction of argmax-correct predictions over a batch (the
    ``validate`` fold, ``app/MNIST.hs:369-377``)."""
    preds = _predictions(net, be, xb)
    return float((preds == np.asarray(yb_idx)).mean())


def batch_loss(net: Network, loss: TOp, be: Backend, xb: Any,
               yb: Any) -> float:
    """Mean loss over a batch: the value-only evaluation used where argmax
    accuracy means nothing (regression, reconstruction)."""
    key = ("bloss", loss.struct_key()) + be.cache_key()

    def build():
        composed = net._loss_op(loss)
        if be.name == "numpy":
            def loop(xb, yb, *params):
                return np.mean([
                    composed.apply(be, (x,) + tuple(params) + (y,))[0]
                    for x, y in zip(xb, yb)])

            return loop

        def single(x, y, *params):
            return composed.apply(be, (x,) + params + (y,))[0]

        return engine.maybe_jit(_vmap(single, 2, len(net.params)), be,
                                "batch_loss")

    fn = _cache(net, key, build)
    return float(fn(be.asarray(xb), be.asarray(yb), *net.params).mean())


def seq_batch_loss(rnet, loss: TOp, be: Backend, XS: Any, TS: Any) -> float:
    """Mean scan-BPTT sequence loss over ``(N, n, *in)`` sequences: the
    value-only evaluation ``fit_sequences`` uses for ``val=`` (``rnet`` is
    any RecurrentNetwork-shaped object: ``._seq_graph``, ``.states``,
    ``.params``, ``.op``)."""
    return float(seq_losses(rnet, loss, be, XS, TS).mean())


def seq_losses(rnet, loss: TOp, be: Backend, XS: Any, TS: Any):
    """Each sequence's scan-BPTT loss: the sequence graph mapped over the N
    sequences with ``torch.func.vmap``, states and params broadcast."""
    XS, TS = be.asarray(XS), be.asarray(TS)
    n = int(XS.shape[1])
    key = ("sbloss", loss.struct_key(), n) + be.cache_key()

    def build():
        g = rnet._seq_graph(loss, n)

        def single(xs, ts, *sp):
            return g.apply(be, (xs,) + sp + (ts,))[0]

        return engine.maybe_jit(
            _vmap(single, 2, len(rnet.states) + len(rnet.params)), be,
            "seq_losses")

    fn = _cache(rnet, key, build)
    return fn(XS, TS, *rnet.states, *rnet.params)


def confusion(net: Network, be: Backend, xb: Any, yb_idx: Any,
              n_classes: int) -> np.ndarray:
    """Confusion matrix ``count[predicted, actual]`` (the ``confusion``
    fold, ``app/MNIST.hs:379-389``)."""
    preds = _predictions(net, be, xb)
    m = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(m, (preds, np.asarray(yb_idx)), 1)
    return m
