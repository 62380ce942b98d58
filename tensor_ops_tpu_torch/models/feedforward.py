"""Feed-forward networks — rebuild of
``src/TensorOps/Learn/NeuralNet/FeedForward.hs``.

A :class:`Network` pairs one staged op ``('[i] : ps) -> '[[o]]`` with its
parameter stack (the reference stores params as an existential shape-list,
``FeedForward.hs:57-61``; here just a tuple of tensors whose shapes are the
op's input stack tail).  Training and gradients compose the network op
with a loss op and run one staged forward + transposition, evaluated
eagerly (the JAX package jits the same graph into one XLA program).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

from .. import engine
from ..backend.base import Backend, normal
from ..backend.rng import Rng
from ..ops import ir
from ..ops import prim as P
from ..ops.ir import Compose, First, TOp
from ..ops.shapes import ShapeError
from .neuralnet import Activation


@dataclass
class Network:
    """``Network t i o`` (``FeedForward.hs:57-61``)."""

    op: TOp           # ('[i] : ps) -> '[[o]]
    params: Tuple[Any, ...]
    act_names: Optional[Tuple[str, ...]] = None  # set by gen_net; lets
    # FusedMLP.from_network pick the fused-kernel activations automatically

    def __post_init__(self):
        self.params = tuple(self.params)
        if len(self.op.in_stack) != 1 + len(self.params):
            raise ShapeError(
                f"Network: op takes {len(self.op.in_stack)} inputs but "
                f"{len(self.params)} params given"
            )
        if len(self.op.out_stack) != 1:
            raise ShapeError("Network: op must produce exactly one output")

    @property
    def in_shape(self):
        return self.op.in_stack[0]

    @property
    def out_shape(self):
        return self.op.out_stack[0]

    @property
    def param_stack(self):
        return self.op.in_stack[1:]

    # -- composition (~*~ / ~* / *~, FeedForward.hs:82-121) -------------
    def then(self, other: "Network") -> "Network":
        """``net1 ~*~ net2`` (``FeedForward.hs:82-90``).  Activation
        metadata concatenates when both sides carry it."""
        if self.out_shape != other.in_shape:
            raise ShapeError(
                f"network compose: {self.out_shape} -> {other.in_shape} mismatch"
            )
        acts = None
        if self.act_names is not None and other.act_names is not None:
            acts = tuple(self.act_names) + tuple(other.act_names)
        return Network(self.op.lead(other.op), self.params + other.params,
                       acts)

    def pre_op(self, f: TOp) -> "Network":
        """``f ~* net`` (``FeedForward.hs:96-101``).  Drops the
        activation metadata: its consumers (``FusedMLP.from_network``,
        the checkpoint->serve rebuild) encode ONLY the layer stack, so
        carrying it past a graph-altering composition would let them
        silently omit ``f``."""
        return Network(f.lead(self.op), self.params)

    def post_op(self, f: TOp) -> "Network":
        """``net *~ f`` (``FeedForward.hs:103-108``).  Drops the
        activation metadata (see ``pre_op``)."""
        return Network(self.op >> f, self.params)

    def nmap(self, f: Callable) -> "Network":
        """``nmap`` (``FeedForward.hs:115-121``)."""
        return self.post_op(P.map_op(self.out_shape, f))

    # -- running ---------------------------------------------------------
    def run(self, be: Backend, x: Any) -> Any:
        """``runNetwork`` (``FeedForward.hs:123-129``): one sample."""
        fn = engine.compile_run(self.op, be)
        return fn(x, *self.params)[0]

    # -- gradients & training (FeedForward.hs:131-199) -------------------
    def _loss_op(self, loss: TOp) -> TOp:
        """Compose ``op *>> loss`` once and cache it on the (stable) op
        object, so functional parameter updates reuse it (``netGrad``
        builds ``o' = o *>> loss``, ``FeedForward.hs:196``)."""
        key = ("loss", loss.struct_key())
        composed = self.op._compiled.get(key)
        if composed is None:
            composed = self.op.lead(loss)
            self.op._compiled[key] = composed
        return composed

    def net_grad(self, loss: TOp, be: Backend, x: Any, y: Any
                 ) -> Tuple[Any, ...]:
        """Gradient w.r.t. (input, *params): runs ``gradTOp`` on
        ``op *>> loss`` with stack ``x : params >: y`` and drops the
        target's gradient (``netGrad``, ``FeedForward.hs:178-199``)."""
        fn = engine.compile_grad(self._loss_op(loss), be)
        return fn(x, *self.params, y)[:-1]

    def network_gradient(self, loss: TOp, be: Backend, x: Any, y: Any
                         ) -> Tuple[Any, ...]:
        """Parameter gradients only (``networkGradient``,
        ``FeedForward.hs:166-176``)."""
        return self.net_grad(loss, be, x, y)[1:]

    def loss_value(self, loss: TOp, be: Backend, x: Any, y: Any) -> Any:
        fn = engine.compile_run(self._loss_op(loss), be)
        return fn(x, *self.params, y)[0]

    def train(self, loss: TOp, rate: float, be: Backend, x: Any, y: Any
              ) -> "Network":
        """One per-sample SGD step ``p <- p - r*g`` (``trainNetwork``,
        ``FeedForward.hs:131-148``)."""
        grads = ir.grad(self._loss_op(loss), be, (x,) + self.params + (y,))
        new_params = tuple(p - rate * g
                           for p, g in zip(self.params, grads[1:-1]))
        return Network(self.op, new_params, self.act_names)

    def induce(self, loss: TOp, rate: float, be: Backend, y: Any, x: Any
               ) -> Any:
        """Gradient descent *on the input*, params fixed
        (``induceNetwork``, ``FeedForward.hs:150-164``)."""
        dx = self.net_grad(loss, be, x, y)[0]
        return x - rate * dx

    def induce_many(self, loss: TOp, rate: float, be: Backend, y: Any,
                    x: Any, steps: int) -> Any:
        """``steps`` induction iterations (``induceNum`` runs 5000
        sequential ``induceNetwork`` calls, ``app/MNIST.hs:399-411``), as
        a Python loop over the staged gradient; the JAX package runs them
        in one jitted ``fori_loop``."""
        composed = self._loss_op(loss)
        xc = x
        for _ in range(int(steps)):
            grads = ir.grad(composed, be, (xc,) + self.params + (y,))
            xc = xc - rate * grads[0]
        return xc


def unchain(op: TOp) -> list:
    """Split an op graph at its ``lead``-composition seams (the build
    pattern of ``Network.then`` / ``gen_net``: ``Compose(First(prefix,
    rest), layer)`` with ``rest`` = the layer's params) into the list of
    per-layer sub-ops, each ``([x] + params_k) -> [y]``.  An op with no
    such seam is returned whole."""
    if (
        isinstance(op, Compose)
        and isinstance(op.f, First)
        and len(op.f.op.out_stack) == 1
        and len(op.g.out_stack) == 1
        and op.f.rest == op.g.in_stack[1:]
    ):
        return unchain(op.f.op) + [op.g]
    return [op]


def lift_net(op: TOp) -> Network:
    """``liftNet`` — a parameterless network (``FeedForward.hs:110-113``)."""
    return Network(op, ())


def ff_layer(be: Backend, i: int, o: int, rng: Rng) -> Network:
    """One fully-connected layer: weights/bias ~ N(0, 0.5), op =
    ``firstOp (swap >>> matVec) >>> add``
    (``ffLayer``, ``FeedForward.hs:201-214``)."""
    w = be.asarray(rng.draw(normal(0.0, 0.5), (o, i)))
    b = be.asarray(rng.draw(normal(0.0, 0.5), (o,)))
    op = P.first(P.swap((i,), (o, i)) >> P.mat_vec(o, i), rest=[(o,)]) >> P.add((o,))
    return Network(op, (w, b))


def gen_net(
    be: Backend,
    i: int,
    o: int,
    hidden: Sequence[Tuple[int, Activation]],
    act_out: Activation,
    rng: Rng,
) -> Network:
    """Build a chain of ``ffLayer``s from runtime layer sizes
    (``genNet``, ``FeedForward.hs:216-235``)."""
    sizes = [i] + [h for h, _ in hidden] + [o]
    acts = [a for _, a in hidden] + [act_out]
    net: Optional[Network] = None
    for k in range(len(sizes) - 1):
        layer = ff_layer(be, sizes[k], sizes[k + 1], rng).post_op(
            acts[k](sizes[k + 1])
        )
        net = layer if net is None else net.then(layer)
    net.act_names = tuple(a.name for a in acts)
    return net
