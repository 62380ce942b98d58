"""Randomized graph fuzzing of the port: random well-shaped op graphs from
the full combinator/primitive vocabulary, built alike in both packages,
checked for (a) the port's value and gradients against the JAX package's
NumPy oracle at 1e-9 in f64 (on the port's torch backend and its NumPy
oracle), (b) gradients against central finite differences and (c)
``torch.autograd`` of the composed forward at 1e-12
(``testing.check_grads_vs_autograd``); and random recurrent cells through
``ScanOp`` the same way.  The port of ``tests/test_fuzz.py`` (20 and 6
seeds, as there); its pipeline fuzz (``:186``) is in
``tests/test_torch_pipeline.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu_torch as TT
from tensor_ops_tpu.ops import ir as j_ir
from tensor_ops_tpu.ops import prim as JP
from tensor_ops_tpu_torch.ops import ir as t_ir
from tensor_ops_tpu_torch.ops import prim as TP
from tensor_ops_tpu_torch.testing import check_grads_vs_autograd, fd_grad
from torch_threads import one_torch_thread  # noqa: F401

DIMS = (2, 3, 4)
TOL = 1e-9
TB = TT.TorchBackend(torch.float64, "cpu")
TNB = TT.NumpyBackend()


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tanh(P):
    if P is JP:
        return jnp.tanh
    return lambda a: (torch.tanh(a) if isinstance(a, torch.Tensor)
                      else np.tanh(a))


def rand_shape(rng):
    rank = rng.integers(1, 3)
    return tuple(int(rng.choice(DIMS)) for _ in range(rank))


def rand_primitive(P, rng, in_stack):
    """A random op consuming a prefix of `in_stack`; returns (op, n_used)."""
    choices = []
    s0 = in_stack[0]
    th = tanh(P)
    # unary ops on slot 0
    choices.append((P.map_op(s0, lambda a: th(a)), 1))
    choices.append((P.scale(s0, float(rng.uniform(0.5, 1.5))), 1))
    choices.append((P.transp_op(s0), 1))
    choices.append((P.duplicate(s0), 1))
    choices.append((P.remat(P.map_op(s0, lambda a: a * a + a)), 1))
    if len(s0) >= 1:
        choices.append((P.sum_rows(s0), 1))
    # binary ops when the next slot matches
    if len(in_stack) >= 2:
        s1 = in_stack[1]
        if s1 == s0:
            choices.append((P.add(s0), 2))
            choices.append((P.zip_op(s0, lambda a, b: a * b), 2))
            choices.append((P.swap(s0, s1), 2))
        if s1 == tuple(reversed(s0)):
            choices.append((P.gmul((), s0, ()), 2))
    i = int(rng.integers(0, len(choices)))
    return choices[i]


def rand_graph(P, rng, in_stack, depth=4):
    """Compose `depth` random layers over the stack."""
    op = P.identity(in_stack)
    stack = tuple(in_stack)
    for _ in range(depth):
        prim, used = rand_primitive(P, rng, stack)
        rest = stack[used:]
        layer = P.first(prim, rest=rest)
        if rng.uniform() < 0.25 and prim.in_stack == prim.out_stack:
            layer = P.first(P.fanout(prim, P.identity(prim.in_stack))
                            >> P.take(prim.out_stack, prim.in_stack),
                            rest=rest)
        op = op >> layer
        stack = op.out_stack
    return op


def scalarize(P, op):
    """Reduce all outputs to one scalar: square-contract each slot and sum."""
    out = op
    while len(out.out_stack) > 1 or out.out_stack[0] != ():
        st = out.out_stack
        s0 = st[0]
        if s0 == ():
            if len(st) == 1:
                break
            if st[1] == ():
                out = out >> P.first(P.add(()), rest=st[2:])
            else:
                out = out >> P.swap_blocks([()], st[1:])
        else:
            red = (P.duplicate(s0)
                   >> P.second(P.transp_op(s0), front=[s0])
                   >> P.gmul((), s0, ()))
            out = out >> P.first(red, rest=st[1:])
    return out


def build(P, seed):
    """Seed ``seed``'s graph and inputs, drawn alike for either package."""
    rng = np.random.default_rng(seed)
    n_in = int(rng.integers(1, 4))
    in_stack = tuple(rand_shape(rng) for _ in range(n_in))
    op = scalarize(P, rand_graph(P, rng, in_stack,
                                 depth=int(rng.integers(2, 6))))
    xs = tuple(rng.normal(size=s) * 0.5 for s in in_stack)
    return op, xs


@pytest.mark.parametrize("seed", range(20))
def test_random_graphs_parity_and_fd(seed, nb):
    op, xs = build(TP, seed)
    jop, jxs = build(JP, seed)
    assert op.out_stack == ((),) == jop.out_stack
    assert op.in_stack == jop.in_stack
    v_j, g_j = j_ir.value_and_grad(jop, nb, jxs)
    for be in (TB, TNB):
        v, g = t_ir.value_and_grad(op, be, tuple(be.asarray(x) for x in xs))
        assert abs(float(v) - float(v_j)) <= TOL * max(1.0, abs(float(v_j)))
        for a, b in zip(g, g_j):
            np.testing.assert_allclose(host(a), np.asarray(b), atol=TOL,
                                       rtol=TOL)
    # finite differences on the NumPy oracle (slot 0 only, for speed)
    _, g_n = t_ir.value_and_grad(op, TNB, xs)
    fd = fd_grad(op, TNB, xs, slot=0)
    np.testing.assert_allclose(host(g_n[0]), fd, atol=1e-4, rtol=1e-3)
    # the independent oracle: torch.autograd of the composed forward
    check_grads_vs_autograd(op, TB, xs)


@pytest.mark.parametrize("seed", range(6))
def test_random_recurrent_scan_fuzz(seed, nb):
    """Random recurrent cells (random widths/activations/extra params)
    through ScanOp: the port's loss and gradients on its two backends
    against the JAX package's NumPy oracle at 1e-9, torch.autograd over
    the whole scan graph, and FD on the initial state."""
    from tensor_ops_tpu.backend.rng import Rng as JRng
    from tensor_ops_tpu.models import squared_error as j_sq
    from tensor_ops_tpu.models.neuralnet import (act_logistic as j_log,
                                                 act_relu as j_relu,
                                                 act_tanh as j_tanh)
    from tensor_ops_tpu.models.recurrent import \
        fully_connected as j_fully_connected

    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import squared_error
    from tensor_ops_tpu_torch.models.neuralnet import (act_logistic,
                                                       act_relu, act_tanh)
    from tensor_ops_tpu_torch.models.recurrent import (RecurrentNetwork,
                                                       fully_connected)

    rng_np = np.random.default_rng(seed)
    i = int(rng_np.choice(DIMS))
    o = int(rng_np.choice(DIMS))
    a = int(rng_np.integers(0, 3))
    jnet = j_fully_connected([j_log, j_tanh, j_relu][a](), nb, i, o,
                             JRng(nb, seed=seed + 100))
    # the port's graph (its own draws are replaced by the JAX net's leaves)
    tmpl = fully_connected([act_logistic, act_tanh, act_relu][a](), TNB, i,
                           o, Rng(TNB, 0))
    if rng_np.uniform() < 0.5:
        o2 = int(rng_np.choice(DIMS))
        jnet = jnet.then(j_fully_connected(j_log(), nb, o, o2,
                                           JRng(nb, seed=seed + 200)))
        tmpl = tmpl.then(fully_connected(act_logistic(), TNB, o, o2,
                                         Rng(TNB, 0)))
        o = o2
    n = int(rng_np.integers(2, 6))
    xs = rng_np.normal(size=(n, i)) * 0.5
    tg = rng_np.normal(size=(n, o)) * 0.5
    v_j = float(np.asarray(jnet.seq_loss(j_sq(o), nb, xs, tg)))
    _, gS_j, gP_j = jnet.seq_grad(j_sq(o), nb, xs, tg)
    for be in (TB, TNB):
        net = RecurrentNetwork(tmpl.op,
                               tuple(be.asarray(s) for s in jnet.states),
                               tuple(be.asarray(p) for p in jnet.params))
        loss = squared_error(o)
        v = float(host(net.seq_loss(loss, be, be.asarray(xs),
                                    be.asarray(tg))))
        assert abs(v - v_j) <= TOL * max(1.0, abs(v_j))
        _, gS, gP = net.seq_grad(loss, be, be.asarray(xs), be.asarray(tg))
        for x, y in zip(gS + gP, gS_j + gP_j):
            np.testing.assert_allclose(host(x), np.asarray(y), atol=TOL,
                                       rtol=TOL)
        if be is TB:
            # torch.autograd over the WHOLE scan graph (inputs, states,
            # params, targets): covers ScanOp's checkpointed backward
            check_grads_vs_autograd(net._seq_graph(loss, n), TB,
                                    (xs,) + jnet.states + jnet.params
                                    + (tg,))
    # FD on the first state's first entry, on the NumPy oracle
    eps = 1e-6
    sp = [np.array(s) for s in jnet.states]
    sm = [np.array(s) for s in jnet.states]
    sp[0][0] += eps
    sm[0][0] -= eps
    loss = squared_error(o)
    params = tuple(np.asarray(p) for p in jnet.params)
    lp = float(RecurrentNetwork(tmpl.op, tuple(sp), params).seq_loss(
        loss, TNB, xs, tg))
    lm = float(RecurrentNetwork(tmpl.op, tuple(sm), params).seq_loss(
        loss, TNB, xs, tg))
    assert abs((lp - lm) / (2 * eps) - float(np.asarray(gS_j[0][0]))) < 1e-4
