"""Feed-forward networks — rebuild of
``src/TensorOps/Learn/NeuralNet/FeedForward.hs``.

A :class:`Network` pairs one staged op ``('[i] : ps) -> '[[o]]`` with its
parameter stack (the reference stores params as an existential shape-list,
``FeedForward.hs:57-61``; here just a tuple of tensors whose shapes are the
op's input stack tail).

This slice of the port carries composition and ``run``; ``train``,
``net_grad`` and ``induce*`` come with the training slice (ROADMAP.md,
Queue 1, "Flagship learn layer").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

from .. import engine
from ..backend.base import Backend, normal
from ..backend.rng import Rng
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
