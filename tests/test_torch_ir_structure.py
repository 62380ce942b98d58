"""Composition laws, structure combinators and graph introspection of the
port's IR (``tensor_ops_tpu_torch.ops``) against the JAX package's: the
port of ``tests/test_ir_structure.py``.

Each case builds the same graph in both packages from the same numpy
inputs, runs the JAX one on the JAX package's NumPy oracle and the port's
on its torch backend (f64, CPU) and its NumPy oracle, holds the port to
the JAX values at 1e-9 and keeps the JAX test's own assertions."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu_torch as TT
from tensor_ops_tpu.ops import ir as j_ir
from tensor_ops_tpu.ops import prim as JP
from tensor_ops_tpu_torch.ops import ir as t_ir
from tensor_ops_tpu_torch.ops import prim as TP
from tensor_ops_tpu_torch.ops.shapes import ShapeError
from tensor_ops_tpu_torch.testing import check_grads, check_grads_vs_autograd
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-9
TB = TT.TorchBackend(torch.float64, "cpu")
TNB = TT.NumpyBackend()


def r(*shape):
    return np.random.default_rng(hash(shape) % 2**32).normal(size=shape)


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_all(build, xs, nb, grad=False):
    """``build(P)``'s graph on the JAX package's NumPy oracle and on the
    port's two backends; the port's outputs (or value and gradients) are
    held to the JAX ones at 1e-9.  Returns the port's torch results."""
    want = (j_ir.value_and_grad if grad else j_ir.run)(build(JP), nb, xs)
    out = None
    for be in (TB, TNB):
        got = (t_ir.value_and_grad if grad else t_ir.run)(
            build(TP), be, tuple(be.asarray(x) for x in xs))
        if grad:
            np.testing.assert_allclose(host(got[0]), np.asarray(want[0]),
                                       atol=TOL, rtol=0)
            got_l, want_l = got[1], want[1]
        else:
            got_l, want_l = got, want
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(host(g), np.asarray(w), atol=TOL,
                                       rtol=0)
        out = got if out is None else out
    return out


def test_identity(nb):
    x = r(3)
    outs = run_all(lambda P: P.identity([(3,)]), (x,), nb)
    assert np.allclose(host(outs[0]), x)


def test_compose_mismatch_raises():
    with pytest.raises(ShapeError):
        TP.mat_vec(3, 2) >> TP.dot(4)


def test_compose_associativity(nb):
    def parts(P):
        a = P.map_op((3,), lambda x: x * 2, lambda x: 2.0 * (x * 0 + 1))
        b = P.map_op((3,), lambda x: x + 1, lambda x: x * 0 + 1.0)
        return a, b, P.sum_rows((3,))

    x = r(3)
    left = run_all(lambda P: (lambda a, b, c: (a >> b) >> c)(*parts(P)),
                   (x,), nb)
    right = run_all(lambda P: (lambda a, b, c: a >> (b >> c))(*parts(P)),
                    (x,), nb)
    assert np.allclose(host(left[0]), host(right[0]))


def test_identity_laws(nb):
    x = (r(3, 2), r(2))
    base = run_all(lambda P: P.mat_vec(3, 2), x, nb)[0]
    pre = run_all(lambda P: P.identity([(3, 2), (2,)]) >> P.mat_vec(3, 2),
                  x, nb)[0]
    post = run_all(lambda P: P.mat_vec(3, 2) >> P.identity([(3,)]), x, nb)[0]
    assert np.allclose(host(pre), host(base))
    assert np.allclose(host(post), host(base))


def test_first_second(nb):
    x, y = r(2), r(3)
    outs = run_all(lambda P: P.first(P.scale((2,), 2.0), rest=[(3,)]),
                   (x, y), nb)
    assert np.allclose(host(outs[0]), 2 * x) and np.allclose(host(outs[1]), y)
    outs = run_all(lambda P: P.second(P.scale((2,), 2.0), front=[(3,)]),
                   (y, x), nb)
    assert np.allclose(host(outs[0]), y) and np.allclose(host(outs[1]), 2 * x)


def test_par(nb):
    x, y = r(2), r(3)
    outs = run_all(lambda P: P.par(P.scale((2,), 2.0), P.scale((3,), -1.0)),
                   (x, y), nb)
    assert np.allclose(host(outs[0]), 2 * x)
    assert np.allclose(host(outs[1]), -y)


def test_fanout_forward(nb):
    x = r(2)
    outs = run_all(lambda P: P.fanout(P.scale((2,), 2.0),
                                      P.scale((2,), 3.0)), (x,), nb)
    assert np.allclose(host(outs[0]), 2 * x)
    assert np.allclose(host(outs[1]), 3 * x)


def test_fanout_gradient_sums(nb):
    # (&&& gradient = sum of both branches' cotangent pullbacks,
    # Types.hs:258-263): f = 2x, g = 3x, loss = dot(f,g) -> d/dx = 12x
    x = r(2)

    def build(P):
        return P.fanout(P.scale((2,), 2.0), P.scale((2,), 3.0)) >> P.dot(2)

    _, grads = run_all(build, (x,), nb, grad=True)
    assert np.allclose(host(grads[0]), 12 * x)
    check_grads(build(TP), TB, (x,))
    check_grads_vs_autograd(build(TP), TB, (x,))


def test_shuffle_forward(nb):
    x, y = r(2), r(3)
    outs = run_all(lambda P: P.shuffle([(2,), (3,)], [1, 0, 0]), (x, y), nb)
    assert np.allclose(host(outs[0]), y)
    assert np.allclose(host(outs[1]), x) and np.allclose(host(outs[2]), x)


def test_shuffle_grad_fanin_and_zero(nb):
    # input 0 used twice (cotangents sum), input 1 unused (zero grad)
    x, y = r(2), r(2)
    _, grads = run_all(lambda P: P.shuffle([(2,), (2,)], [0, 0]) >> P.dot(2),
                       (x, y), nb, grad=True)
    assert np.allclose(host(grads[0]), 2 * x)
    assert np.allclose(host(grads[1]), 0.0)


def test_swap_and_blocks(nb):
    x, y, z = r(2), r(3), r(4)
    outs = run_all(lambda P: P.swap((2,), (3,)), (x, y), nb)
    assert np.allclose(host(outs[0]), y) and np.allclose(host(outs[1]), x)
    outs = run_all(lambda P: P.swap_blocks([(2,), (3,)], [(4,)]), (x, y, z),
                   nb)
    assert np.allclose(host(outs[0]), z)
    assert np.allclose(host(outs[1]), x) and np.allclose(host(outs[2]), y)


def test_drop_take_zero_grads(nb):
    x, y = r(2), r(2)
    _, grads = run_all(lambda P: P.drop([(2,)], [(2,)]) >> P.duplicate((2,))
                       >> P.dot(2), (x, y), nb, grad=True)
    assert np.allclose(host(grads[0]), 0.0)  # dropped slot: zero-filled
    assert np.allclose(host(grads[1]), 2 * y)
    _, grads2 = run_all(lambda P: P.take([(2,)], [(2,)]) >> P.duplicate((2,))
                        >> P.dot(2), (x, y), nb, grad=True)
    assert np.allclose(host(grads2[0]), 2 * x)
    assert np.allclose(host(grads2[1]), 0.0)


def test_lead_infers_passthrough(nb):
    # f *>> g with f: [2]->[2], g: [[2],[2]] -> scalar
    x, y = r(2), r(2)
    v = run_all(lambda P: P.scale((2,), 2.0).lead(P.dot(2)), (x, y), nb)[0]
    assert np.isclose(float(v), float((2 * x) @ y))


def test_fanout_requires_same_inputs():
    with pytest.raises(ShapeError):
        TP.fanout(TP.scale((2,), 1.0), TP.scale((3,), 1.0))


def test_mapped_op_multi_output(nb, jb):
    """MappedOp over an op with several outputs (duplicate)."""
    from tensor_ops_tpu.ops.loops import MappedOp as JMapped

    from tensor_ops_tpu_torch.ops.loops import MappedOp as TMapped

    xsb = r(4, 3)
    mapped = {JP: JMapped, TP: TMapped}
    outs = run_all(lambda P: mapped[P](P.duplicate((3,)), 4), (xsb,), nb)
    assert len(outs) == 2
    np.testing.assert_allclose(host(outs[0]), xsb, atol=1e-12)
    np.testing.assert_allclose(host(outs[1]), xsb, atol=1e-12)
    # transpose: cotangents from both outputs sum
    _, grads = run_all(lambda P: mapped[P](P.duplicate((3,)), 4)
                       >> mapped[P](P.dot(3), 4) >> P.sum_rows((4,)),
                       (xsb,), nb, grad=True)
    np.testing.assert_allclose(host(grads[0]), 2 * xsb, atol=1e-10)


def test_konst_multi_output_in_graph(nb):
    v = run_all(lambda P: P.konst(3.0, (2,), n=2) >> P.dot(2), (), nb)[0]
    assert np.isclose(float(v), 18.0)  # [3,3].[3,3]
    # grad over empty input stack works
    _, grads = run_all(lambda P: P.konst(3.0, (2,), n=2) >> P.dot(2), (), nb,
                       grad=True)
    assert grads == ()


def test_deep_composition_stress(nb):
    """200-node chain builds, runs, and differentiates in O(depth)."""
    def build(P):
        op = P.identity([(4,)])
        for _ in range(200):
            op = op >> P.scale((4,), 1.001)
        return op >> P.duplicate((4,)) >> P.dot(4)

    x = r(4)
    _, grads = run_all(build, (x,), nb, grad=True)
    scale = 1.001 ** 200
    np.testing.assert_allclose(host(grads[0]), 2 * x * scale * scale,
                               rtol=1e-9)


def test_remat_gradients_identical(nb):
    """remat(op) computes the same values and gradients as op, storing
    only inputs as residuals."""
    import jax.numpy as jnp

    from tensor_ops_tpu_torch.ops.loops import Remat

    def tanh(P):
        return ((lambda a: jnp.tanh(a)) if P is JP else
                (lambda a: torch.tanh(a) if isinstance(a, torch.Tensor)
                 else np.tanh(a)))

    def chain(P):
        return (P.map_op((3,), tanh(P))
                >> P.map_op((3,), lambda a: a * a + a))

    x = r(3)
    v1, g1 = run_all(lambda P: chain(P) >> P.duplicate((3,)) >> P.dot(3),
                     (x,), nb, grad=True)
    v2, g2 = run_all(lambda P: P.remat(chain(P)) >> P.duplicate((3,))
                     >> P.dot(3), (x,), nb, grad=True)
    assert np.isclose(float(v1), float(v2))
    np.testing.assert_allclose(host(g1[0]), host(g2[0]), atol=1e-12)
    # the remat tape is exactly the input tuple
    xt = TB.asarray(x)
    _, tape = Remat(chain(TP)).apply_tape(TB, (xt,))
    assert isinstance(tape, tuple) and len(tape) == 1 and tape[0] is xt


def test_runtime_shape_validation():
    """Arrays that do not match the declared stack fail loudly at the
    entry point, not deep inside a backend op."""
    for be in (TB, TNB):
        with pytest.raises(ShapeError, match="slot 1"):
            t_ir.run(TP.mat_vec(3, 2), be, (be.asarray(r(3, 2)),
                                            be.asarray(r(3))))
        with pytest.raises(ShapeError, match="slot 0"):
            t_ir.value_and_grad(TP.dot(3), be, (be.asarray(r(4)),
                                                be.asarray(r(3))))


def test_describe_and_graph_stats(nb):
    """ops.describe renders every node with its stack signature;
    graph_stats counts nodes/depth/leaf types; max_depth truncates; the
    port's renderings of the same network and scan equal the JAX
    package's."""
    from tensor_ops_tpu.backend.rng import Rng as JRng
    from tensor_ops_tpu.models import act_logistic as j_logistic
    from tensor_ops_tpu.models import act_softmax as j_softmax
    from tensor_ops_tpu.models import gen_net as j_gen_net
    from tensor_ops_tpu.ops import describe as j_describe
    from tensor_ops_tpu.ops import graph_stats as j_stats
    from tensor_ops_tpu.ops.loops import ScanOp as JScan

    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import act_logistic, act_softmax, gen_net
    from tensor_ops_tpu_torch.ops import describe, graph_stats
    from tensor_ops_tpu_torch.ops.loops import ScanOp

    net = gen_net(TB, 4, 2, [(3, act_logistic())], act_softmax(),
                  Rng(TB, seed=0))
    jnet = j_gen_net(nb, 4, 2, [(3, j_logistic())], j_softmax(),
                     JRng(nb, seed=0))
    full = describe(net.op)
    assert "Compose" in full and "GMul" in full and "->" in full
    assert full.count("\n") + 1 == graph_stats(net.op)["nodes"]
    assert full == j_describe(jnet.op)

    short = describe(net.op, max_depth=2)
    assert "more nodes" in short and short.count("\n") < full.count("\n")
    assert short == j_describe(jnet.op, max_depth=2)

    s = graph_stats(net.op)
    assert s["nodes"] == 27 and s["depth"] >= 5
    assert s["leaves"]["GMul"] == 3          # matVec + 2 softmax gmuls
    assert "[4]" in s["signature"]
    assert s == j_stats(jnet.op)

    # scan/mapped nodes expose their inner step too
    scan = ScanOp(TP.add((3,)).first(rest=[(3,)]), n=4, n_state=1)
    jscan = JScan(JP.add((3,)).first(rest=[(3,)]), n=4, n_state=1)
    assert "step: First" in describe(scan) and "SumOp" in describe(scan)
    assert describe(scan) == j_describe(jscan)


def test_describe_handles_deep_chains():
    """Introspection is iterative: a then-chain far beyond Python's
    recursion depth renders and counts fine, and max_depth truncation
    doesn't recurse into the suppressed subtree."""
    from tensor_ops_tpu_torch.ops import describe, graph_stats

    g = TP.map_op((4,), lambda x: x, name="id0")
    for i in range(1200):
        g = g >> TP.map_op((4,), lambda x: x, name=f"id{i}")
    s = graph_stats(g)
    assert s["nodes"] == 2401 and s["depth"] >= 1200
    short = describe(g, max_depth=3)
    assert "more nodes" in short and short.count("\n") < 20
