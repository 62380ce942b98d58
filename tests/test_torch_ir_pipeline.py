"""The port's staged-IR pipelines (``tensor_ops_tpu_torch.parallel.
ir_pipeline``) against the JAX package's, on the CPU in f64.

Each case builds one ``gen_net`` chain with the JAX package, copies its
parameters into the port's graph of the same chain, and runs the same numpy
batch through the JAX function on the conftest's 8 CPU devices and through
the port on ``["cpu"] * n`` ranks: the partitions' leaves agree bit for bit,
the pipelined losses and gradients within 1e-9 of each other and of the
sequential staged-IR gradient (``make_vmapped_grads``), and the
``describe_partition`` texts are equal.  The ports of
``tests/test_ir_pipeline.py``'s cases without a model axis are here, with
kernel 9's calls per forward and per step against the schedule's count and
the check that every segment's gradient is its ``op.transpose``."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu.parallel.ir_pipeline as JI
import tensor_ops_tpu.parallel.pipeline as JP
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.ops.shapes import ShapeError as JShapeError
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.training import make_vmapped_grads
from tensor_ops_tpu_torch.ops.shapes import ShapeError
from tensor_ops_tpu_torch.parallel import collective_kernels as CK
from tensor_ops_tpu_torch.parallel import ir_pipeline as TI
from tensor_ops_tpu_torch.parallel import pipeline as TP
from tensor_ops_tpu_torch.utils.checkpoint import network_from_arrays
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
ACTS = {"logistic": (j_logistic, t_logistic), "softmax": (j_softmax,
                                                          t_softmax)}
LOSSES = {"sq": (j_sq, t_sq), "xent": (j_xent, t_xent)}

multi = pytest.mark.skipif(len(jax.devices()) < 8,
                           reason="needs the 8-device CPU mesh")


def nets(i, o, hidden, out_act="logistic", seed=0):
    """``(jax net, port net)``: one gen_net chain (``hidden`` a list of
    (width, activation name)) drawn by the JAX package from ``seed``, the
    port's graph of the same chain holding its parameters."""
    jn = j_gen_net(JB, i, o, [(h, ACTS[a][0]()) for h, a in hidden],
                   ACTS[out_act][0](), JRng(JB, seed=seed))
    tmpl = t_gen_net(TB, i, o, [(h, ACTS[a][1]()) for h, a in hidden],
                     ACTS[out_act][1](), TRng(TB, 0))
    return jn, network_from_arrays(
        {f"param_{k}": np.asarray(p) for k, p in enumerate(jn.params)}, {},
        tmpl, TB)


def uniform_chain(h=6, n_layers=4, seed=0):
    return nets(h, h, [(h, "logistic")] * (n_layers - 1), seed=seed)


def flagship(seed=0):
    return nets(784, 10, [(300, "logistic"), (100, "logistic")], "softmax",
                seed)


def deep_pyramid(seed=0):
    """24->20->16->12->8->12->16->20->24: the uniform circular split
    rejects it, the heterogeneous circular cut takes it."""
    return nets(24, 24, [(w, "logistic") for w in (20, 16, 12, 8, 12, 16,
                                                   20)], seed=seed)


def meshes(shape):
    """The JAX package's and the port's (CPU ranks) stage mesh of
    ``shape``: ``(S,)`` or ``(dp, S)``."""
    if len(shape) == 1:
        return (JP.make_pipeline_mesh(*shape),
                TP.make_pipeline_mesh(*shape, devices=["cpu"] * shape[0]))
    return (JP.make_dp_pipeline_mesh(*shape),
            TP.make_dp_pipeline_mesh(*shape, devices=["cpu"] * int(
                np.prod(shape))))


def host(xs):
    return [np.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# partitions: the JAX layouts, leaf for leaf
# ---------------------------------------------------------------------------


def test_unchain_recovers_layers():
    jn, tn = uniform_chain(h=5, n_layers=3)
    jsegs, tsegs = JI.network_segments(jn), TI.network_segments(tn)
    assert len(tsegs) == len(jsegs) == 3
    for (jo, jp), (to, tp) in zip(jsegs, tsegs):
        assert to.in_stack == jo.in_stack == ((5,), (5, 5), (5,))
        assert to.out_stack == jo.out_stack == ((5,),)
    assert sum(len(p) for _, p in tsegs) == len(tn.params)
    for (seg, p), w, b in zip(tsegs, tn.params[0::2], tn.params[1::2]):
        assert p[0] is w and p[1] is b


def test_split_network_uniform_body():
    jn, tn = uniform_chain(h=4, n_layers=4)
    jp, tp = JI.split_network(jn, 4), TI.split_network(tn, 4)
    assert tp.n_body == jp.n_body == 4 and not tp.pre and not tp.post
    assert tuple(tp.body_params[0].shape) == (4, 4, 4)
    assert tuple(tp.body_params[1].shape) == (4, 4)
    for a, b in zip(host(tp.flat_params()), host(jp.flat_params())):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(tp.to_network_params()[2]),
                                  np.asarray(tn.params[2]))


def test_split_network_rejects_short_body():
    jn, tn = uniform_chain(h=4, n_layers=2)
    with pytest.raises(JShapeError, match="structurally identical"):
        JI.split_network(jn, 4)
    with pytest.raises(ShapeError, match="structurally identical"):
        TI.split_network(tn, 4)


def test_balanced_partition_minimizes_max():
    r = np.random.default_rng(0)
    cases = [([10, 1, 1, 10], 2), ([5, 5, 5], 3), ([1, 1, 1, 1, 100], 2)]
    cases += [(list(r.uniform(0, 10, size=9)), k) for k in (2, 3, 4)]
    assert TI._balanced_partition([10, 1, 1, 10], 2) == [(0, 2), (2, 4)]
    assert TI._balanced_partition([1, 1, 1, 1, 100], 2) == [(0, 4), (4, 5)]
    for costs, k in cases:
        assert TI._balanced_partition(costs, k) == \
            JI._balanced_partition(costs, k)
    jn, tn = flagship()
    for (jo, _), (to, _) in zip(JI.network_segments(jn),
                                TI.network_segments(tn)):
        assert TI._op_flops(to) == JI._op_flops(jo)


def test_split_network_hetero_flagship():
    jn, tn = flagship()
    jp, tp = JI.split_network_hetero(jn, 3), TI.split_network_hetero(tn, 3)
    assert tp.n_stages == 3 and tp.width == jp.width == 784
    assert tp.lmax == jp.lmax
    assert [len(ops) for ops in tp.stage_ops] == [1, 1, 1]
    np.testing.assert_array_equal(np.asarray(tp.packed),
                                  np.asarray(jp.packed))
    back = tp.to_network_params()
    assert len(back) == len(tn.params)
    for a, b in zip(back, tn.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_partition_network_dispatch():
    assert isinstance(TI.partition_network(uniform_chain(n_layers=4)[1], 4),
                      TI.PipelinedNetwork)
    assert isinstance(TI.partition_network(flagship()[1], 3),
                      TI.HeteroPipelinedNetwork)


def test_interleave_perm_roundtrip():
    jn, tn = uniform_chain(h=4, n_layers=9, seed=11)  # 8-segment body
    jp, tp = (JI.split_network_circular(jn, 4, 2),
              TI.split_network_circular(tn, 4, 2))
    assert tp.n_stages == 4 and tp.n_chunks == 2
    np.testing.assert_array_equal(TI._interleave_perm(8, 4, 2),
                                  JI._interleave_perm(8, 4, 2))
    for a, b in zip(host(tp.flat_params()), host(jp.flat_params())):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.to_network_params(), tn.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_split_hetero_circular_roundtrip():
    jn, tn = deep_pyramid()
    jp, tp = (JI.split_network_hetero_circular(jn, 4, 2),
              TI.split_network_hetero_circular(tn, 4, 2))
    assert tp.S == 4 and tp.V == 2 and tuple(tp.packed.shape[:2]) == (4, 2)
    assert tp.in_width == tp.out_width == tp.width == 24
    np.testing.assert_array_equal(np.asarray(tp.packed),
                                  np.asarray(jp.packed))
    back = tp.to_network_params()
    assert len(back) == len(tn.params)
    for a, b in zip(back, tn.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(TI.partition_network_circular(tn, 4, 2),
                      TI.HeteroCircularPipelinedNetwork)
    assert isinstance(TI.partition_network_circular(
        uniform_chain(h=4, n_layers=9)[1], 4, 2), TI.CircularPipelinedNetwork)


def test_describe_partition():
    """Every kind renders the JAX package's text, character for
    character."""
    (jf, tf), (ju, tu), (jy, ty) = flagship(), uniform_chain(), deep_pyramid()
    pairs = [(JI.split_network_hetero(jf, 3), TI.split_network_hetero(tf, 3)),
             (JI.split_network(ju, 2), TI.split_network(tu, 2)),
             (JI.split_network_circular(ju, 2, 2),
              TI.split_network_circular(tu, 2, 2)),
             (JI.split_network_hetero_circular(jy, 4, 2),
              TI.split_network_hetero_circular(ty, 4, 2)),
             (JI.split_network_hetero_circular(jy, 2, 2),
              TI.split_network_hetero_circular(ty, 2, 2))]
    for jp, tp in pairs:
        assert TI.describe_partition(tp) == JI.describe_partition(jp)
    s = TI.describe_partition(pairs[0][1])
    assert "heterogeneous partition: 3 stages" in s
    assert "784->300" in s and "balance:" in s
    assert "exactly balanced" in TI.describe_partition(pairs[1][1])
    assert "2 chunks/device" in TI.describe_partition(pairs[2][1])
    s = TI.describe_partition(pairs[3][1])
    assert "heterogeneous circular partition: 4 stages x 2 chunks" in s
    assert "chunk 7 (device 3, slot 1)" in s
    with pytest.raises(TypeError, match="not a pipeline partition"):
        TI.describe_partition(tu)


def test_describe_circular_balance_is_per_device():
    p = TI.split_network_hetero_circular(deep_pyramid()[1], 2, 2)
    per_chunk = [sum(TI._op_flops(op) for op in ops) for ops in p.chunk_ops]
    dev = [per_chunk[0] + per_chunk[2], per_chunk[1] + per_chunk[3]]
    want = max(dev) / (sum(dev) / 2)
    assert f"max/mean stage FLOPs = {want:.2f}" in TI.describe_partition(p)


@multi
def test_circular_pnet_stage_mismatch_rejected():
    """A prebuilt partition for another stage count is refused, not trained
    as another network (the JAX package's checks, and its messages)."""
    jn, tn = deep_pyramid()
    jm2, tm2 = meshes((2,))
    for lib, net, mesh, loss, be in ((JI, jn, jm2, j_sq(24), JB),
                                     (TI, tn, tm2, t_sq(24), TB)):
        with pytest.raises(ValueError, match="built for 4 stages"):
            lib.make_ir_pipeline_loss(
                net, loss, be, mesh, 4,
                pnet=lib.split_network_hetero_circular(net, 4, 2),
                schedule="circular", n_chunks=2)
        with pytest.raises(ValueError, match="built for 4 stages"):
            lib.make_ir_pipeline_loss(net, loss, be, mesh, 2,
                                      pnet=lib.split_network_hetero(net, 4))
    ju, tu = nets(8, 8, [(8, "logistic")] * 7, seed=1)
    for lib, net, mesh, loss, be in ((JI, ju, jm2, j_sq(8), JB),
                                     (TI, tu, tm2, t_sq(8), TB)):
        with pytest.raises(ValueError, match="built for 4 stages"):
            lib.make_ir_pipeline_loss(
                net, loss, be, mesh, 4,
                pnet=lib.split_network_circular(net, 4, 2),
                schedule="circular", n_chunks=2)
    with pytest.raises(ValueError, match="n_microbatches"):
        TI.make_ir_pipeline_loss(tu, t_sq(8), TB, tm2, 1,
                                 schedule="circular")


@multi
def test_model_axis_refused_naming_item_9c3():
    """A stage mesh with a model axis, refused before the tensor-parallel
    pipelines were ported, now runs in every entry point: on (1, 2, 2) the
    body's rows split over the model axis, and the loss and gradients equal
    the JAX package's and the sequential ones at 1e-9.  A model axis of 1
    is a (data, stage) mesh."""
    jn, tn = uniform_chain(h=8, n_layers=5)
    m3 = TP.make_3d_pipeline_mesh(1, 2, 2, devices=["cpu"] * 4)
    jm3 = JP.make_3d_pipeline_mesh(1, 2, 2)
    part = TI.partition_network(tn, 2, m3)
    loss_fn, pnet = TI.make_ir_pipeline_loss(tn, t_sq(8), TB, m3, 2)
    assert TI.pipeline_tp_segment(pnet, m3) is not None
    assert TI.pipelined_specs(part, m3) == TI.pipelined_specs(pnet, m3)
    x, y = _batch(8, 8, 8, seed=2, onehot=False)
    step, _ = TI.ir_pipeline_train_step(tn, t_sq(8), TB, m3, 2)
    v, new = step(0.1, x, y, *pnet.flat_params())
    jstep, jp = JI.ir_pipeline_train_step(jn, j_sq(8), JB, jm3, 2)
    jv, jnew = jstep(0.1, JB.asarray(x), JB.asarray(y), *jp.flat_params())
    assert abs(float(v) - float(jv)) < ATOL
    for a, b in zip(host(new), host(jnew)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    sv, g = _seq(tn, t_sq(8), x, y)
    assert abs(float(loss_fn(pnet.flat_params(), x, y)) - sv) < ATOL
    # a model axis of 1 is a (data, stage) mesh
    m1 = TP.make_3d_pipeline_mesh(1, 2, 1, devices=["cpu"] * 2)
    TI.make_ir_pipeline_loss(tn, t_sq(8), TB, m1, 2)


# ---------------------------------------------------------------------------
# gradients: the port against the JAX package and the sequential graph
# ---------------------------------------------------------------------------


def _batch(B, i, o, seed, onehot):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, size=(B, i))
    y = (np.eye(o)[r.integers(0, o, size=B)] if onehot
         else r.uniform(0, 1, size=(B, o)))
    return x, y


def _seq(tn, loss, x, y):
    vals, grads = make_vmapped_grads(tn, loss, TB)(
        TB.asarray(x), TB.asarray(y), *tn.params)
    return float(vals.mean()), [g.mean(dim=0).numpy() for g in grads]


# name: (chain, loss, mesh shape, M, schedule, B, step lr or None)
CASES = {
    "uniform": (lambda: uniform_chain(h=6, n_layers=4), "sq", (4,), 2,
                "gpipe", 8, None),
    "pre/post": (lambda: nets(8, 4, [(16, "logistic")] * 5, "softmax", 3),
                 "xent", (4,), 2, "gpipe", 8, 0.5),
    "dp x pp": (lambda: uniform_chain(h=4, n_layers=4, seed=7), "sq",
                (2, 4), 2, "gpipe", 8, None),
    "hetero flagship": (flagship, "xent", (3,), 4, "gpipe", 12, 0.1),
    "circular M=4": (lambda: uniform_chain(h=4, n_layers=9, seed=13), "sq",
                     (4,), 4, "circular", 12, None),
    "circular M=6": (lambda: uniform_chain(h=4, n_layers=9, seed=13), "sq",
                     (4,), 6, "circular", 12, None),
    "hetero circular M=4": (lambda: deep_pyramid(23), "sq", (4,), 4,
                            "circular", 12, None),
    "hetero circular M=6": (lambda: deep_pyramid(23), "sq", (4,), 6,
                            "circular", 12, None),
}


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX run (loss and gradients, or the new parameters of
    its SGD step), computed once."""
    return {}


def _jax_run(name, jn, x, y):
    _, loss, shape, M, sched, _, lr = CASES[name]
    jm, _ = meshes(shape)
    jl = LOSSES[loss][0](jn.out_shape[0])
    step, pnet = JI.ir_pipeline_train_step(jn, jl, JB, jm, M,
                                           schedule=sched, n_chunks=2)
    if lr is None:
        v, flat = JI.ir_pipeline_grads(jn, jl, JB, jm, M, schedule=sched,
                                       n_chunks=2)(x, y, *pnet.flat_params())
    else:
        v, flat = step(lr, x, y, *pnet.flat_params())
    return float(v), host(flat), host(pnet.flat_params())


@multi
@pytest.mark.parametrize("name", list(CASES))
def test_ir_pipeline_grads_match_jax_and_sequential(runs, name):
    """The pipelined batch-mean gradient (or one SGD step) of every form:
    the port's within 1e-9 of the JAX package's and of the sequential
    staged-IR gradient, the partition's leaves bit-equal to the JAX
    package's."""
    chain, loss, shape, M, sched, B, lr = CASES[name]
    jn, tn = chain()
    x, y = _batch(B, tn.in_shape[0], tn.out_shape[0], seed=B + M,
                  onehot=loss == "xent")
    if name not in runs:
        runs[name] = _jax_run(name, jn, JB.asarray(x), JB.asarray(y))
    jv, jflat, jleaves = runs[name]
    _, tm = meshes(shape)
    tl = LOSSES[loss][1](tn.out_shape[0])
    step, pnet = TI.ir_pipeline_train_step(tn, tl, TB, tm, M, schedule=sched,
                                           n_chunks=2)
    for a, b in zip(host(pnet.flat_params()), jleaves):
        np.testing.assert_array_equal(a, b)
    if lr is None:
        v, flat = TI.ir_pipeline_grads(tn, tl, TB, tm, M, schedule=sched,
                                       n_chunks=2)(x, y, *pnet.flat_params())
    else:
        v, flat = step(lr, x, y, *pnet.flat_params())
    assert all(f.spec == s for f, s in zip(flat, TI.pipelined_specs(pnet)))
    assert abs(float(v) - jv) < ATOL
    for a, b in zip(host(flat), jflat):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    sv, g = _seq(tn, tl, x, y)
    assert abs(float(v) - sv) < ATOL
    got = pnet.unflatten(tuple(flat)).to_network_params()
    for p, gg, nn in zip(tn.params, g, got):
        want = gg if lr is None else p.numpy() - lr * gg
        np.testing.assert_allclose(np.asarray(nn), want, atol=ATOL, rtol=0)


def test_forward_and_loss_equal_the_sequential_net():
    """``loss_fn.forward`` (the rows in order, gathered over the data
    groups) and ``loss_fn(...)`` equal the sequential net's output and mean
    loss, on each form."""
    for chain, loss, shape, M, sched in (
            (lambda: uniform_chain(h=4, n_layers=9, seed=13), "sq", (2, 2),
             2, "circular"),
            (flagship, "xent", (2, 3), 2, "gpipe"),
            (lambda: deep_pyramid(1), "sq", (2,), 4, "circular")):
        _, tn = chain()
        x, y = _batch(8, tn.in_shape[0], tn.out_shape[0], seed=M,
                      onehot=loss == "xent")
        _, tm = meshes(shape)
        tl = LOSSES[loss][1](tn.out_shape[0])
        loss_fn, pnet = TI.make_ir_pipeline_loss(tn, tl, TB, tm, M,
                                                 schedule=sched)
        out = loss_fn.forward(pnet.flat_params(), x)
        want = torch.func.vmap(lambda a, *p: tn.op.apply(TB, (a,) + p)[0],
                               in_dims=(0,) + (None,) * len(tn.params))(
            TB.asarray(x), *tn.params)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
        assert abs(float(loss_fn(pnet.flat_params(), x, y))
                   - _seq(tn, tl, x, y)[0]) < ATOL


def test_gradients_come_from_the_ir_transposition(monkeypatch):
    """Autograd orchestrates the schedule only: each segment's backward is
    its op's ``transpose`` (counted: once per segment call), and a loss
    whose transpose doubles its cotangent doubles every gradient."""
    _, tn = nets(8, 4, [(16, "logistic")] * 5, "softmax", 3)
    tl = t_xent(4)
    x, y = _batch(8, 8, 4, seed=1, onehot=True)
    _, tm = meshes((2, 2))
    M = 2
    pnet = TI.split_network(tn, 2)
    body, loss_op = pnet.body_op, tl
    seen = collections.Counter()
    cls_b, cls_l = type(body), type(loss_op)
    real_b, real_l = cls_b.transpose, cls_l.transpose
    scale = [1.0]

    def counted(self, be, tape, cts):
        if self is body:
            seen["body"] += 1
        if self is loss_op:
            seen["loss"] += 1
            return tuple(scale[0] * c for c in real_l(self, be, tape, cts))
        return real_b(self, be, tape, cts)

    monkeypatch.setattr(cls_b, "transpose", counted)
    if cls_l is not cls_b:
        monkeypatch.setattr(cls_l, "transpose", counted)
    grads = TI.ir_pipeline_grads(tn, tl, TB, tm, M)
    v1, g1 = grads(x, y, *pnet.flat_params())
    # 4 body segments x M microbatches on each of the 2 data groups, and
    # the loss once a data group
    assert seen == {"body": 4 * M * 2, "loss": 2}
    scale[0] = 2.0
    v2, g2 = grads(x, y, *pnet.flat_params())
    assert float(v2) == float(v1)
    for a, b in zip(g1, g2):
        np.testing.assert_array_equal(2 * np.asarray(a), np.asarray(b))


def test_ir_call_keeps_the_tape_and_transposes():
    """``ir_call`` (one sample): value and gradient equal the IR's own
    ``value_and_grad``."""
    from tensor_ops_tpu_torch.ops import ir

    _, tn = uniform_chain(h=5, n_layers=2, seed=2)
    op = tn._loss_op(t_sq(5))
    x = TB.asarray(np.random.default_rng(3).uniform(size=5))
    y = TB.asarray(np.random.default_rng(4).uniform(size=5))
    xs = [x] + [p.clone().requires_grad_() for p in tn.params] + [y]
    (v,) = TI.ir_call(op, TB)(*xs)
    gs = torch.autograd.grad(v, xs[1:-1])
    v0, g0 = ir.value_and_grad(op, TB, tuple([x] + list(tn.params) + [y]))
    assert float(v.detach()) == float(v0)
    for a, b in zip(gs, g0[1:-1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# kernel 9's calls
# ---------------------------------------------------------------------------


def _counted(fn):
    """``fn()`` with kernel 9's calls of more than one rank (what launches
    on a card) counted by phase."""
    seen = collections.Counter()
    real = CK._collective

    def spy(xs, phase, *a, **k):
        if len(xs) > 1:
            seen[phase] += 1
        return real(xs, phase, *a, **k)

    CK._collective = spy
    try:
        out = fn()
    finally:
        CK._collective = real
    return out, {p: seen[p] for p in ("ar", "rs", "ag")}


def predicted(shape, n_leaves: int, n_repl: int, train: bool) -> dict:
    """Kernel 9's calls of one forward or one gradient of a staged-IR
    pipeline: the stage psum once per data group (and its transpose once
    per data group), the rows gathered over the data groups (forward) or
    the loss averaged over them (gradient), each replicated leaf's
    gradient summed over each data group's stage ranks, and each leaf's
    gradient averaged over the data axis (one call per stage rank)."""
    dp, S = (1,) * (2 - len(shape)) + tuple(shape)
    psum = dp * (S > 1)
    if not train:
        return {"ar": psum, "rs": 0, "ag": int(dp > 1)}
    return {"ar": 2 * psum + n_repl * psum + (dp > 1)
            + (n_leaves * S if dp > 1 else 0), "rs": 0, "ag": 0}


@pytest.mark.parametrize("shape,chain,sched,M", [
    ((4,), lambda: nets(8, 4, [(16, "logistic")] * 5, "softmax", 3),
     "gpipe", 2),
    ((2, 2), lambda: nets(8, 4, [(16, "logistic")] * 5, "softmax", 3),
     "circular", 2),
    ((2, 3), flagship, "gpipe", 2),
    ((2,), lambda: deep_pyramid(1), "circular", 4)])
def test_kernel9_calls_per_forward_and_gradient(shape, chain, sched, M):
    _, tn = chain()
    x, y = _batch(8, tn.in_shape[0], tn.out_shape[0], seed=1, onehot=True)
    _, tm = meshes(shape)
    loss_fn, pnet = TI.make_ir_pipeline_loss(tn, t_xent(tn.out_shape[0]),
                                             TB, tm, M, schedule=sched)
    specs = TI.pipelined_specs(pnet)
    n_repl = sum("stage" not in s for s in specs)
    _, got_f = _counted(lambda: loss_fn.forward(pnet.flat_params(), x))
    _, got_g = _counted(lambda: loss_fn.value_and_grad(pnet.flat_params(),
                                                       x, y))
    assert got_f == predicted(shape, len(specs), n_repl, False)
    assert got_g == predicted(shape, len(specs), n_repl, True)
