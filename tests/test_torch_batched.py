"""The port's batched lowering (``models/batched.py``) against the JAX
package's ``tests/test_batched.py``: the batch-mean loss as a BATCHED
staged-IR graph gives the vmapped per-sample mean gradients, its forward
the per-sample forward, on both of the port's backends; and on the same
numpy parameters it equals the JAX package's batched graph at 1e-9 in
f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_relu as j_relu
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.models.batched import batched_loss_graph as j_blg
from tensor_ops_tpu.ops import ir as jir
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (act_logistic, act_relu, act_softmax,
                                         cross_entropy, gen_net,
                                         squared_error)
from tensor_ops_tpu_torch.models.batched import (batch_network_op,
                                                 batched_loss_graph)
from tensor_ops_tpu_torch.models.feedforward import Network
from tensor_ops_tpu_torch.models.training import make_vmapped_grads
from tensor_ops_tpu_torch.ops import ir
from tensor_ops_tpu_torch.ops import prim as P
from torch_threads import one_torch_thread  # noqa: F401

TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()
JB = T.JaxBackend(dtype=jnp.float64)


def _net(be, seed=0):
    return gen_net(be, 7, 4, [(6, act_logistic()), (5, act_relu())],
                   act_softmax(), Rng(be, seed))


def _batch(B, seed=0):
    r = np.random.default_rng(seed)
    return r.uniform(0, 1, size=(B, 7)), np.eye(4)[r.integers(0, 4, size=B)]


@pytest.mark.parametrize("loss_fn", [cross_entropy, squared_error])
def test_batched_grads_equal_vmapped_mean(loss_fn):
    net = _net(TB)
    loss = loss_fn(4)
    B = 9
    xb, yb = (TB.asarray(a) for a in _batch(B))
    g = batched_loss_graph(net, loss, B)
    assert g is not None
    v, grads = ir.value_and_grad(g, TB, (xb,) + net.params + (yb,))
    vals, pg = make_vmapped_grads(net, loss, TB)(xb, yb, *net.params)
    assert abs(float(v) - float(vals.mean())) < 1e-11
    for a, b in zip(grads[1:-1], pg):
        np.testing.assert_allclose(a.numpy(), b.mean(dim=0).numpy(),
                                   atol=1e-11, rtol=0)


def test_batched_forward_equals_per_sample():
    """The batched network op equals per-sample runs, on BOTH of the port's
    backends (the NumPy oracle runs BroadcastRows and the batched GMul
    too)."""
    for be in (TNB, TB):
        net = _net(be, seed=3)
        B = 5
        bop = batch_network_op(net.op, B)
        assert bop is not None
        xb = be.asarray(_batch(B, seed=1)[0])
        out = np.asarray(ir.run(bop, be, (xb,) + net.params)[0])
        for k in range(B):
            want = np.asarray(net.run(be, xb[k]))
            np.testing.assert_allclose(out[k], want, atol=1e-12, rtol=0)


def test_batched_graph_caches_and_rejects_unknown():
    net = _net(TB)
    loss = cross_entropy(4)
    g1 = batched_loss_graph(net, loss, 8)
    assert batched_loss_graph(net, loss, 8) is g1  # cached
    # a matrix-input matVec net is outside the supported family -> None,
    # and the negative result is cached too
    odd = Network(P.first(P.mat_vec(3, 3), rest=[]), (TB.asarray(np.ones(3)),))
    assert batch_network_op(odd.op, 4) is None
    assert batched_loss_graph(odd, squared_error(3), 4) is None
    assert odd.op._compiled.get(("batched_loss",
                                 squared_error(3).struct_key(), 4)) is False


def test_broadcast_rows_primitive():
    op = P.broadcast_rows((3,), 4)
    scalar = (op >> P.map_op((4, 3), lambda x: x * x)
              >> P.sum_rows((4, 3)) >> P.sum_rows((3,)))
    for be in (TNB, TB):
        v = be.asarray(np.arange(3.0))
        out = np.asarray(ir.run(op, be, (v,))[0])
        assert out.shape == (4, 3)
        np.testing.assert_array_equal(out, np.tile(np.arange(3.0), (4, 1)))
        # d/dv sum_rows(sum_rows(broadcast(v)^2)) = 2 * 4 * v, and a
        # central difference agrees
        g = np.asarray(ir.grad(scalar, be, (v,))[0])
        np.testing.assert_allclose(g, 8 * np.arange(3.0), atol=1e-12)
        h = 1e-6
        fd = [(float(ir.run(scalar, be, (be.asarray(np.arange(3.0) + h * e),))[0])
               - float(ir.run(scalar, be, (be.asarray(np.arange(3.0) - h * e),))[0]))
              / (2 * h) for e in np.eye(3)]
        np.testing.assert_allclose(g, fd, atol=1e-6)


def test_fit_mixed_precision_uses_batched_graph():
    """fit(mixed_precision="bf16") routes through the batched lowering (the
    graph lands in the cache) and still learns."""
    from tensor_ops_tpu_torch.models.trainer import fit

    be = TorchBackend(torch.float32, "cpu")
    net = _net(be, seed=5)
    r = np.random.default_rng(2)
    X = r.uniform(0, 1, size=(64, 7))
    Y = np.eye(4)[np.argmax(X @ r.normal(size=(7, 4)), axis=1)]
    res = fit(net, cross_entropy(4), be, X, Y, epochs=8, batch_size=16,
              lr=0.5, mixed_precision="bf16", verbose=False, log_every=1)
    losses = [h["loss"] for h in res.history]
    assert all(np.isfinite(v) for v in losses)
    assert np.mean(losses[-4:]) < losses[0], losses
    assert any(isinstance(k, tuple) and k and k[0] == "batched_loss"
               for k in net.op._compiled), "the batched graph was not built"


@pytest.mark.parametrize("loss_name", ["cross_entropy", "squared_error"])
def test_batched_graph_matches_jax(loss_name):
    """The port's batched graph and the JAX package's, on the same numpy
    parameters and batch in f64: value and every gradient at 1e-9."""
    jn = j_gen_net(JB, 7, 4, [(6, j_logistic()), (5, j_relu())], j_softmax(),
                   JRng(JB, seed=11))
    params = tuple(np.asarray(p) for p in jn.params)
    tn = _net(TB)
    tn = Network(tn.op, tuple(TB.asarray(p) for p in params), tn.act_names)
    B = 6
    x, y = _batch(B, seed=4)
    jloss = (j_xent if loss_name == "cross_entropy" else j_sq)(4)
    tloss = (cross_entropy if loss_name == "cross_entropy"
             else squared_error)(4)
    jv, jg = jir.value_and_grad(j_blg(jn, jloss, B), JB,
                                (JB.asarray(x),) + jn.params
                                + (JB.asarray(y),))
    tv, tg = ir.value_and_grad(batched_loss_graph(tn, tloss, B), TB,
                               (TB.asarray(x),) + tn.params
                               + (TB.asarray(y),))
    assert abs(float(tv) - float(jv)) <= 1e-9
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
