"""Gradient checks for every primitive op of the port, with the three
oracles of ``tests/test_grads.py`` (whose port this is): central finite
differences (``testing.check_grads``) on the port's NumPy oracle and torch
backend, ``torch.autograd`` of the composed forward
(``testing.check_grads_vs_autograd``, the port's ``check_grads_vs_jax``)
at 1e-12, and the JAX package's value and gradients of the same graph at
1e-9 in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu_torch as TT
from tensor_ops_tpu.ops import ir as j_ir
from tensor_ops_tpu.ops import prim as JP
from tensor_ops_tpu_torch.ops import ir as t_ir
from tensor_ops_tpu_torch.ops import prim as TP
from tensor_ops_tpu_torch.testing import (check_grads,
                                          check_grads_vs_autograd)
from tensor_ops_tpu_torch.testing import rand as r
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-9
TB = TT.TorchBackend(torch.float64, "cpu")
TNB = TT.NumpyBackend()


def fn(name):
    """An elementwise function of either package's values: jnp for the JAX
    package, torch or numpy for the port's backends."""
    def f(P):
        if P is JP:
            return getattr(jnp, name)
        return lambda a: (getattr(torch, name)(a) if isinstance(a, torch.Tensor)
                          else getattr(np, name)(a))
    return f


def sq(P, shape):
    """Reduce a tensor to a scalar smoothly: sum of squares, via
    duplicate >> transp-the-copy >> full contraction."""
    sh = tuple(shape)
    return (P.duplicate(sh) >> P.second(P.transp_op(sh), front=[sh])
            >> P.gmul((), sh, ()))


def check_all(build, jb, xs):
    """FD on both port backends, torch.autograd on the torch backend, and
    the JAX package's value and gradients at 1e-9."""
    op = build(TP)
    check_grads(op, TNB, xs)
    check_grads(op, TB, xs)
    check_grads_vs_autograd(op, TB, xs)
    jv, jg = j_ir.value_and_grad(build(JP), jb,
                                 tuple(jb.asarray(x) for x in xs))
    for be in (TB, TNB):
        tv, tg = t_ir.value_and_grad(op, be, tuple(be.asarray(x) for x in xs))
        assert abs(float(tv) - float(jv)) <= TOL
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("ms,os,ns", [((2,), (3,), ()), ((2,), (3,), (4,)),
                                      ((2,), (3, 4), (5,)), ((), (3,), ())])
def test_grad_gmul_cases(jb, ms, os, ns):
    x = r(1, *(ms + os))
    y = r(2, *(tuple(reversed(os)) + ns))
    check_all(lambda P: P.gmul(ms, os, ns) >> sq(P, ms + ns), jb, (x, y))


def test_grad_transp(jb):
    check_all(lambda P: P.transp_op((2, 3)) >> sq(P, (3, 2)), jb,
              (r(3, 2, 3),))


def test_grad_sum_rows(jb):
    check_all(lambda P: P.sum_rows((4, 3)) >> sq(P, (3,)), jb, (r(4, 4, 3),))


def test_grad_sum_op(jb):
    check_all(lambda P: P.sum_op(3, (3,)) >> sq(P, (3,)), jb,
              (r(5, 3), r(6, 3), r(7, 3)))


def test_grad_scale(jb):
    check_all(lambda P: P.scale((3,), -1.7) >> sq(P, (3,)), jb, (r(8, 3),))


def test_grad_replicate(jb):
    check_all(lambda P: P.replicate_op((3,), 2) >> P.dot(3), jb, (r(9, 3),))


def test_grad_konst_drops(jb):
    x = r(10, 3)

    def build(P):
        # konst contributes no gradient; x flows through dot with it
        return P.konst(2.0, (3,), n=1).second(front=[(3,)]) >> P.dot(3)

    for be in (TB, TNB):
        _, grads = t_ir.value_and_grad(build(TP), be, (be.asarray(x),))
        np.testing.assert_allclose(np.asarray(grads[0]), np.full(3, 2.0))
    check_all(build, jb, (x,))


def test_grad_diag_getdiag(jb):
    check_all(lambda P: P.diag_op(4, 2) >> sq(P, (4, 4)), jb, (r(11, 4),))
    check_all(lambda P: P.get_diag_op(4, 2) >> sq(P, (4,)), jb,
              (r(12, 4, 4),))


def test_grad_map_with_and_without_closed_form(jb):
    x = np.abs(r(13, 3)) + 0.5
    check_all(lambda P: P.map_op((3,), fn("log")(P), lambda a: 1.0 / a)
              >> sq(P, (3,)), jb, (x,))
    # the derivative derived by the backend's AD (the reference's `ad`
    # package path)
    check_all(lambda P: P.map_op((3,), lambda a, t=fn("tanh")(P): t(a) * a)
              >> sq(P, (3,)), jb, (x,))


def test_grad_zipn(jb):
    check_all(lambda P: P.zip3_op((3,), lambda a, b, c: a * b * c,
                                  lambda a, b, c: (b * c, a * c, a * b))
              >> sq(P, (3,)), jb, (r(14, 3), r(15, 3), r(16, 3)))


def test_grad_inner_outer(jb):
    check_all(lambda P: P.outer((3,), (4,)) >> sq(P, (3, 4)), jb,
              (r(17, 3), r(18, 4)))
    check_all(lambda P: P.inner((3,), 4, ()) >> sq(P, (3,)), jb,
              (r(19, 3, 4), r(20, 4)))


def test_grad_deep_chain(jb):
    """Deep composed chain: tape-based transposition stays exact (and
    O(depth), unlike the reference's recompute chain rule)."""
    def build(P):
        op = P.identity([(3,)])
        for _ in range(12):
            op = op >> P.map_op((3,), fn("tanh")(P))
        return op >> sq(P, (3,))

    check_all(build, jb, (r(21, 3),))


def test_autograd_oracle_catches_wrong_vjp():
    """The torch.autograd oracle is live: a deliberately wrong (but
    FD-plausible at loose tolerance) closed-form map gradient trips it."""
    x = r(22, 3)
    wrong = TP.map_op((3,), torch.tanh,
                      lambda a: 1.0 - torch.tanh(a) ** 2 + 1e-4) >> sq(TP,
                                                                      (3,))
    with pytest.raises(AssertionError, match="torch.autograd"):
        check_grads_vs_autograd(wrong, TB, (x,))
