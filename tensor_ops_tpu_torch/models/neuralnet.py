"""Activations and losses — rebuild of
``src/TensorOps/Learn/NeuralNet.hs`` with identical op compositions.

An :class:`Activation` is a *shape-polymorphic* single-tensor op (the
reference universally quantifies the size: ``Activation k``,
``NeuralNet.hs:15-19``); here it is a builder ``n -> TOp [[n]] [[n]]``
memoized per size.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

from ..ops import prim as P
from ..ops.ir import TOp
from ..ops.shapes import SCALAR


@dataclass
class Activation:
    """Shape-polymorphic elementwise (or vector) activation
    (``NeuralNet.hs:15-19``)."""

    name: str
    build: Callable[[int], TOp]
    _cache: Dict[int, TOp] = field(default_factory=dict, repr=False)

    def __call__(self, n: int) -> TOp:
        op = self._cache.get(n)
        if op is None:
            op = self.build(n)
            self._cache[n] = op
        return op


def act_map(f: Callable, name: str = "act") -> Activation:
    """``actMap`` — derivative derived automatically
    (``NeuralNet.hs:21-25``)."""
    return Activation(name, lambda n: P.map_op((n,), f, name=name))


def act_map2(f: Callable, df: Callable, name: str = "act") -> Activation:
    """``actMap'`` — explicit derivative (``NeuralNet.hs:27-32``)."""
    return Activation(name, lambda n: P.map_op((n,), f, df, name=name))


def _dispatch(name):
    """One elementwise fn usable on numpy arrays and torch tensors: numpy
    arrays go to numpy's ufunc, everything else (tensors, including the
    batched tensors ``torch.func`` passes) to torch's function."""

    def f(x, *rest):
        import numpy as np
        import torch

        mod = np if isinstance(x, np.ndarray) else torch
        return getattr(mod, name)(x, *rest)

    f.__name__ = name
    return f


_exp = _dispatch("exp")
_log = _dispatch("log")


def logistic(x):
    """``logistic`` (``NeuralNet.hs:42-44``)."""
    return 1.0 / (1.0 + _exp(-x))


def logistic_prime(x):
    """Closed-form derivative (``logistic'``, ``NeuralNet.hs:46-50``)."""
    s = logistic(x)
    return s * (1.0 - s)


def act_logistic() -> Activation:
    """``actLogistic`` (``NeuralNet.hs:38-40``)."""
    return act_map2(logistic, logistic_prime, "logistic")


_where = _dispatch("where")


def act_relu() -> Activation:
    """ReLU (rebuild extra; the reference ships only logistic/softmax but
    ``actMap`` admits any scalar fn, ``NeuralNet.hs:21-25``)."""
    return act_map2(lambda x: _where(x > 0, x, 0.0 * x),
                    lambda x: _where(x > 0, 1.0 + 0.0 * x, 0.0 * x), "relu")


_tanh = _dispatch("tanh")


def act_tanh() -> Activation:
    """tanh (rebuild extra)."""
    return act_map2(_tanh, lambda x: 1.0 - _tanh(x) ** 2, "tanh")


def softmax(n: int) -> TOp:
    """``softmax = map exp >>> duplicate >>> firstOp (sumRows >>> map recip)
    >>> outer [] [n]`` — scalar (x) vector outer product
    (``NeuralNet.hs:52-59``)."""
    sh = (n,)
    return (
        P.map_op(sh, _exp, _exp, name="exp")
        >> P.duplicate(sh)
        >> P.first(P.sum_rows(sh) >> P.map_op(SCALAR, lambda x: 1.0 / x, lambda x: -1.0 / (x * x), "recip"), rest=[sh])
        >> P.outer((), sh)
    )


def act_softmax() -> Activation:
    """``actSoftmax`` (``NeuralNet.hs:34-36``)."""
    return Activation("softmax", softmax)


def activation_by_name(name: str) -> Activation:
    """The named activation factory — inverse of ``Activation.name``,
    used to rebuild a graph from checkpoint metadata (``save_network``
    stores ``net.act_names``)."""
    table = {
        "logistic": act_logistic,
        "relu": act_relu,
        "tanh": act_tanh,
        "softmax": act_softmax,
    }
    if name not in table:
        raise ValueError(
            f"unknown activation {name!r} (known: {sorted(table)})")
    return table[name]()


def squared_error(o: int) -> TOp:
    """``squaredError = negate *>> add >>> duplicate >>> dot`` on stack
    ``[prediction, target]`` (``NeuralNet.hs:61-68``)."""
    sh = (o,)
    return P.negate(sh).lead(P.add(sh) >> P.duplicate(sh) >> P.dot(o))


def cross_entropy(o: int) -> TOp:
    """``crossEntropy = map log *>> dot >>> negate`` — target is the
    second stack item (``NeuralNet.hs:70-77``)."""
    sh = (o,)
    return P.map_op(sh, _log, lambda x: 1.0 / x, "log").lead(
        P.dot(o) >> P.negate(SCALAR)
    )
