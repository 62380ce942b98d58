"""Batched training: the upgrade over the reference's strictly per-sample
SGD hot loop (``trainAll = foldl' trainNetwork``, ``app/MNIST.hs:390-396``).

The staged per-sample graph is mapped over the batch axis with
``torch.func.vmap`` (params broadcast) and the per-sample gradients are
averaged, so the card sees ``[B, i] x [o, i]`` products instead of rank-1
chains.  The AD is still the framework's own graph transposition (vmap maps
over it); ``torch.autograd`` is never used on the model.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

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


def batched_run(net: Network, be: Backend) -> Callable:
    """Batched inference ``fn(xb, *params) -> yb``."""
    key = ("brun",) + be.cache_key()

    def build():
        def single(x, *params):
            return net.op.apply(be, (x,) + params)[0]

        return _vmap(single, 1, len(net.params))

    return _cache(net, key, build)


def batched_step(net: Network, loss: TOp, be: Backend) -> Callable:
    """Minibatch SGD step ``fn(rate, xb, yb, *params) -> (mean_loss,
    new_params)``: per-sample transposition AD, vmapped, mean-reduced."""
    key = ("bstep", loss.struct_key()) + be.cache_key()

    def build():
        vmapped = make_vmapped_grads(net, loss, be)

        def step(rate, xb, yb, *params):
            vals, grads = vmapped(xb, yb, *params)
            new_params = tuple(p - rate * g.mean(dim=0)
                               for p, g in zip(params, grads))
            return vals.mean(), new_params

        return step

    return _cache(net, key, build)


def train_fold(net: Network, loss: TOp, be: Backend, rate: float, X: Any,
               Y: Any) -> Network:
    """The reference's per-sample SGD fold (``trainAll = foldl'
    trainNetwork``, ``app/MNIST.hs:390-396``): a Python loop over the
    samples carrying the parameters, the same steps as calling
    :meth:`Network.train` per sample (the JAX package runs them as one
    ``lax.scan``)."""
    composed = net._loss_op(loss)
    params = net.params
    for x, y in zip(X, Y):
        grads = ir.grad(composed, be, (x,) + params + (y,))
        params = tuple(p - rate * g for p, g in zip(params, grads[1:-1]))
    return Network(net.op, params, net.act_names)


def train_minibatch(net: Network, loss: TOp, be: Backend, rate: float,
                    xb: Any, yb: Any) -> Tuple[Any, Network]:
    """One minibatch SGD step; returns (mean loss, updated network)."""
    step = batched_step(net, loss, be)
    v, new_params = step(rate, xb, yb, *net.params)
    return v, Network(net.op, new_params, net.act_names)


def _predictions(net: Network, be: Backend, xb: Any) -> np.ndarray:
    out = batched_run(net, be)(be.asarray(xb), *net.params)
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

        def single(x, y, *params):
            return composed.apply(be, (x,) + params + (y,))[0]

        return _vmap(single, 2, len(net.params))

    fn = _cache(net, key, build)
    return float(fn(be.asarray(xb), be.asarray(yb), *net.params).mean())


def seq_batch_loss(rnet, loss: TOp, be: Backend, XS: Any, TS: Any) -> float:
    """Mean scan-BPTT sequence loss over ``(N, n, *in)`` sequences: the
    value-only evaluation ``fit_sequences`` uses for ``val=`` (``rnet`` is
    any RecurrentNetwork-shaped object: ``._seq_graph``, ``.states``,
    ``.params``, ``.op``).  The sequence graph is mapped over the N
    sequences with ``torch.func.vmap``, states and params broadcast."""
    XS, TS = be.asarray(XS), be.asarray(TS)
    n = int(XS.shape[1])
    key = ("sbloss", loss.struct_key(), n) + be.cache_key()

    def build():
        g = rnet._seq_graph(loss, n)

        def single(xs, ts, *sp):
            return g.apply(be, (xs,) + sp + (ts,))[0]

        return _vmap(single, 2, len(rnet.states) + len(rnet.params))

    fn = _cache(rnet, key, build)
    return float(fn(XS, TS, *rnet.states, *rnet.params).mean())


def confusion(net: Network, be: Backend, xb: Any, yb_idx: Any,
              n_classes: int) -> np.ndarray:
    """Confusion matrix ``count[predicted, actual]`` (the ``confusion``
    fold, ``app/MNIST.hs:379-389``)."""
    preds = _predictions(net, be, xb)
    m = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(m, (preds, np.asarray(yb_idx)), 1)
    return m
