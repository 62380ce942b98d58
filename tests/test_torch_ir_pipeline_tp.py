"""The port's tensor-parallel staged-IR pipelines (``tensor_ops_tpu_torch.
parallel.ir_pipeline`` on a ``(data, stage, model)`` mesh) against the JAX
package's, on the CPU in f64.

Each case builds one ``gen_net`` chain with the JAX package, copies its
parameters into the port's graph of the same chain, and runs the same numpy
batch through the JAX function on the conftest's 8 CPU devices and through
the port on ``["cpu"] * 8`` ranks: the partitions' packed leaves agree bit
for bit, the pipelined losses and gradients (or one SGD step) within 1e-9
of each other and of the sequential staged-IR gradient
(``make_vmapped_grads``).  These are the ports of ``tests/
test_ir_pipeline.py``'s model-axis cases, with kernel 9's calls per forward
and per gradient against the schedule's count, and the check that the
gather's transpose lets every cotangent into the model group once (a loss
whose transpose doubles its cotangent doubles every gradient).  The count
is ``chip_smoke.irp_tp_predicted``, the prediction phase 27 checks on the
card."""

import collections
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tensor_ops_tpu as T
import tensor_ops_tpu.parallel.ir_pipeline as JI
import tensor_ops_tpu.parallel.pipeline as JP
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_relu as j_relu
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import act_tanh as j_tanh
from tensor_ops_tpu.models import adam as j_adam
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_relu as t_relu
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import act_tanh as t_tanh
from tensor_ops_tpu_torch.models import adam as t_adam
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.models.training import make_vmapped_grads
from tensor_ops_tpu_torch.parallel import collective_kernels as CK
from tensor_ops_tpu_torch.parallel import ir_pipeline as TI
from tensor_ops_tpu_torch.parallel import pipeline as TP
from tensor_ops_tpu_torch.parallel.mesh import MODEL_AXIS, STAGE_AXIS
from tensor_ops_tpu_torch.utils.checkpoint import network_from_arrays
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
JNB = T.NumpyBackend()
TB = TorchBackend(torch.float64, "cpu")
ACTS = {"logistic": (j_logistic, t_logistic), "softmax": (j_softmax,
                                                          t_softmax),
        "relu": (j_relu, t_relu), "tanh": (j_tanh, t_tanh)}
LOSSES = {"sq": (j_sq, t_sq), "xent": (j_xent, t_xent)}

multi = pytest.mark.skipif(len(jax.devices()) < 8,
                           reason="needs the 8-device CPU mesh")


def nets(i, o, hidden, out_act="logistic", seed=0):
    """``(jax net, port net)``: one gen_net chain (``hidden`` a list of
    (width, activation name)) drawn by the JAX package from ``seed`` (on its
    NumPy backend's stream, which compiles nothing per shape), the port's
    graph of the same chain holding its parameters."""
    jn = j_gen_net(JB, i, o, [(h, ACTS[a][0]()) for h, a in hidden],
                   ACTS[out_act][0](), JRng(JNB, seed=seed))
    tmpl = t_gen_net(TB, i, o, [(h, ACTS[a][1]()) for h, a in hidden],
                     ACTS[out_act][1](), TRng(TB, 0))
    return jn, network_from_arrays(
        {f"param_{k}": np.asarray(p) for k, p in enumerate(jn.params)}, {},
        tmpl, TB)


def uniform_chain(h, n_layers, seed):
    return nets(h, h, [(h, "logistic")] * (n_layers - 1), seed=seed)


def pyramid(seed=0):
    """16->8->4->8->16 logistic: every segment row-splits over tp=2."""
    return nets(16, 16, [(8, "logistic"), (4, "logistic"), (8, "logistic")],
                seed=seed)


def deep_pyramid(seed=0):
    """24->20->16->12->8->12->16->20->24: the uniform circular split
    rejects it, the heterogeneous circular cuts take it."""
    return nets(24, 24, [(w, "logistic") for w in (20, 16, 12, 8, 12, 16,
                                                   20)], seed=seed)


def odd_pyramid(seed=0):
    """24->21->15->9->7->9->15->21->24: no tp=2 row split exists."""
    return nets(24, 24, [(w, "logistic") for w in (21, 15, 9, 7, 9, 15,
                                                   21)], seed=seed)


def softmax_chain(n_hidden, seed):
    return nets(16, 4, [(8, "logistic")] * n_hidden, "softmax", seed)


def meshes(shape=(2, 2, 2)):
    """The JAX package's and the port's (CPU ranks) 3-D pipeline mesh."""
    return (JP.make_3d_pipeline_mesh(*shape),
            TP.make_3d_pipeline_mesh(*shape, devices=["cpu"] * int(
                np.prod(shape))))


def host(xs):
    return [np.asarray(x) for x in xs]


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


# ---------------------------------------------------------------------------
# gradients: the port against the JAX package and the sequential graph
# ---------------------------------------------------------------------------


def _pipelined(pair, loss, M, sched, B, seed, lr=None, kind=None):
    """The JAX package's and the port's pipelined gradient (``lr`` None) or
    SGD step of ``pair`` on the (2, 2, 2) meshes: the packed leaves
    bit-equal, the loss and the results within 1e-9 of each other and of
    the sequential staged-IR gradient.  Returns the port's partition."""
    jn, tn = pair
    x, y = _batch(B, tn.in_shape[0], tn.out_shape[0], seed,
                  onehot=loss == "xent")
    jm, tm = meshes()
    jl, tl = (f(tn.out_shape[0]) for f in LOSSES[loss])
    step, jp = JI.ir_pipeline_train_step(jn, jl, JB, jm, M, schedule=sched,
                                         n_chunks=2)
    flat0 = JI.shard_pipelined_params(jp, jm).flat_params()
    if lr is None:
        jv, jflat = JI.ir_pipeline_grads(jn, jl, JB, jm, M, schedule=sched,
                                         n_chunks=2)(x, y, *flat0)
    else:
        jv, jflat = step(lr, x, y, *flat0)
    jv, jflat, jleaves = float(jv), host(jflat), host(jp.flat_params())
    step, pnet = TI.ir_pipeline_train_step(tn, tl, TB, tm, M, schedule=sched,
                                           n_chunks=2)
    if kind is not None:
        assert isinstance(pnet, kind)
    for a, b in zip(host(pnet.flat_params()), jleaves):
        np.testing.assert_array_equal(a, b)
    placed = TI.shard_pipelined_params(pnet, tm).flat_params()
    if lr is None:
        v, flat = TI.ir_pipeline_grads(tn, tl, TB, tm, M, schedule=sched,
                                       n_chunks=2)(x, y, *placed)
    else:
        v, flat = step(lr, x, y, *placed)
    assert all(f.spec == s for f, s in zip(flat,
                                            TI.pipelined_specs(pnet, tm)))
    assert abs(float(v) - jv) < ATOL
    for a, b in zip(host(flat), jflat):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    sv, g = _seq(tn, tl, x, y)
    assert abs(float(v) - sv) < ATOL
    got = pnet.unflatten(tuple(flat)).to_network_params()
    for p, gg, nn in zip(tn.params, g, got):
        want = gg if lr is None else p.numpy() - lr * gg
        np.testing.assert_allclose(np.asarray(nn), want, atol=ATOL, rtol=0)
    return pnet


@multi
def test_ir_pipeline_tp_grads_equal_sequential():
    """(stage=2, model=2) + dp: the uniform body's rows split over the
    model axis; one SGD step equals the JAX package's and the sequential
    gradient's at 1e-9, the body stacks over both axes."""
    pnet = _pipelined(uniform_chain(8, 5, 9), "xent", 2,
                      "gpipe", 8, 3, lr=0.1, kind=TI.PipelinedNetwork)
    _, tm = meshes()
    assert TI.pipeline_tp_segment(pnet, tm) is not None
    for x in TI.shard_pipelined_params(pnet, tm).body_params:
        assert x.spec[:2] == (STAGE_AXIS, MODEL_AXIS)
        assert x.shards[0].shape[:2] == (2, 4)


@multi
def test_ir_circular_with_tp():
    """The circular schedule (V=2) with the body's rows split over the
    model axis: gradients equal the JAX package's and the sequential ones
    at 1e-9."""
    _pipelined(uniform_chain(8, 5, 17), "xent", 2,
               "circular", 8, 5, kind=TI.CircularPipelinedNetwork)


def _roundtrip(jp, tp_, net):
    """A tensor-parallel partition's packed leaf bit-equal to the JAX
    package's, and its per-rank row slices rebuilding the exact stack."""
    assert tp_ is not None and jp is not None
    np.testing.assert_array_equal(np.asarray(tp_.packed),
                                  np.asarray(jp.packed))
    back = tp_.to_network_params()
    assert len(back) == len(net.params)
    for a, b in zip(back, net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_split_hetero_tp_roundtrip():
    jn, tn = pyramid()
    p = TI.split_network_hetero_tp(tn, 2, 2)
    assert p.n_stages == 2 and p.tp == 2
    assert tuple(p.packed.shape[:2]) == (2, 2)
    _roundtrip(JI.split_network_hetero_tp(jn, 2, 2), p, tn)
    # the softmax head splits too: the affine rows and exp row-local, the
    # normalization a replicated suffix after the gather
    js, ts = nets(16, 4, [(8, "logistic")], "softmax", 1)
    ps = TI.split_network_hetero_tp(ts, 2, 2)
    assert ps.local_ops[-1][-1][1] is not None
    assert ps.local_ops[0][0][1] is None
    _roundtrip(JI.split_network_hetero_tp(js, 2, 2), ps, ts)
    # odd widths do not split
    _, odd = nets(16, 5, [(8, "logistic")], "softmax", 1)
    assert TI.split_network_hetero_tp(odd, 2, 2) is None


def test_split_hetero_tp_roundtrip_fuzz():
    """Random chains (tp-divisible widths, mixed activations, a logistic or
    softmax head) at random (S, tp): the packed per-rank row slices
    bit-equal to the JAX package's and rebuilding the exact stack."""
    r = np.random.default_rng(0)
    acts = ["logistic", "relu", "tanh"]
    for trial in range(12):
        tp = int(r.choice([2, 4]))
        n_layers = int(r.integers(2, 5))
        widths = [int(tp * r.integers(1, 5)) for _ in range(n_layers + 1)]
        hidden = [(w, acts[int(r.integers(0, 3))]) for w in widths[1:-1]]
        head = "softmax" if trial % 2 else "logistic"
        jn, tn = nets(widths[0], widths[-1], hidden, head, 100 + trial)
        S = int(r.integers(2, n_layers + 1))
        p = TI.split_network_hetero_tp(tn, S, tp)
        assert p.n_stages == S and p.tp == tp
        if trial % 2:
            loc, suf = p.local_ops[-1][-1]
            assert suf.in_stack == ((widths[-1],),)
            assert loc.out_stack[0][0] == widths[-1] // tp
        _roundtrip(JI.split_network_hetero_tp(jn, S, tp), p, tn)


@multi
def test_hetero_tp_grads_equal_sequential():
    """The all-elementwise pyramid on (2, 2, 2): the tensor-parallel
    heterogeneous partition, its packed leaf over both axes, one SGD step
    equal to the JAX package's and the sequential gradient's at 1e-9."""
    pnet = _pipelined(pyramid(3), "sq", 2, "gpipe", 8, 4,
                      lr=0.1, kind=TI.HeteroTpPipelinedNetwork)
    _, tm = meshes()
    sp = TI.shard_pipelined_params(pnet, tm)
    assert sp.packed.spec == (STAGE_AXIS, MODEL_AXIS, None)
    assert tuple(sp.packed.shards[0].shape) == (1, 1, pnet.lmax)


@multi
def test_hetero_tp_softmax_grads_equal_sequential():
    """A flagship-shaped softmax chain (16->8->4): the sharded-softmax
    decomposition's step equals the JAX package's and the sequential one
    at 1e-9."""
    _pipelined(softmax_chain(1, 11), "xent", 2,
               "gpipe", 8, 12, lr=0.1, kind=TI.HeteroTpPipelinedNetwork)


@multi
@pytest.mark.parametrize("M", [2, 4])
def test_hetero_tp_circular_grads_equal_sequential(M):
    """The heterogeneous circular cut row-split over the model axis (M ==
    S and the M > S FIFO): gradients equal the JAX package's and the
    sequential ones at 1e-9, the packed leaf over (stage, model)."""
    pnet = _pipelined(deep_pyramid(41),
                      "sq", M, "circular", 8, 42,
                      kind=TI.HeteroTpCircularPipelinedNetwork)
    _, tm = meshes()
    sp = TI.shard_pipelined_params(pnet, tm)
    assert sp.packed.spec == (STAGE_AXIS, None, MODEL_AXIS, None)
    assert tuple(sp.packed.shards[0].shape) == (1, 2, 1, pnet.lmax)


@multi
def test_hetero_tp_circular_softmax_grads_equal_sequential():
    _pipelined(softmax_chain(3, 43),
               "xent", 4, "circular", 8, 44,
               kind=TI.HeteroTpCircularPipelinedNetwork)


def test_split_hetero_tp_circular_roundtrip():
    """The (S, V, tp, Lmax) packed rows equal the JAX package's and rebuild
    the exact stack; the dispatcher takes the tp cut only on a model axis
    every width divides."""
    jn, tn = deep_pyramid()
    p = TI.split_network_hetero_tp_circular(tn, 2, 2, 2)
    assert p.S == 2 and p.V == 2 and p.tp == 2
    assert tuple(p.packed.shape[:3]) == (2, 2, 2)
    assert p.in_width == p.out_width == p.width == 24
    _roundtrip(JI.split_network_hetero_tp_circular(jn, 2, 2, 2), p, tn)
    js, ts = softmax_chain(3, 1)
    ps = TI.split_network_hetero_tp_circular(ts, 2, 2, 2)
    assert ps.local_ops[-1][-1][1] is not None
    assert ps.local_ops[0][0][1] is None
    _roundtrip(JI.split_network_hetero_tp_circular(js, 2, 2, 2), ps, ts)
    assert TI.split_network_hetero_tp_circular(odd_pyramid()[1],
                                               2, 2, 2) is None
    _, tm = meshes()
    assert isinstance(TI.partition_network_circular(tn, 2, 2, tm),
                      TI.HeteroTpCircularPipelinedNetwork)
    assert isinstance(TI.partition_network_circular(
        odd_pyramid()[1], 2, 2, tm),
                      TI.HeteroCircularPipelinedNetwork)
    assert isinstance(TI.partition_network_circular(
        uniform_chain(4, 8, 0)[1], 2, 2, tm), TI.CircularPipelinedNetwork)
    assert isinstance(TI.partition_network(pyramid()[1], 2, tm),
                      TI.HeteroTpPipelinedNetwork)
    assert isinstance(TI.partition_network(pyramid()[1], 2),
                      TI.HeteroPipelinedNetwork)


def test_split_hetero_tp_circular_roundtrip_fuzz():
    r = np.random.default_rng(7)
    acts = ["logistic", "relu", "tanh"]
    for trial in range(10):
        tp = int(r.choice([2, 4]))
        n_layers = int(r.integers(4, 9))
        widths = [int(tp * r.integers(1, 5)) for _ in range(n_layers + 1)]
        hidden = [(w, acts[int(r.integers(0, 3))]) for w in widths[1:-1]]
        head = "softmax" if trial % 2 else "logistic"
        jn, tn = nets(widths[0], widths[-1], hidden, head, 200 + trial)
        S = int(r.integers(2, 4))
        V = int(r.integers(1, 3))
        if S * V > n_layers:
            V = 1
        if S * V > n_layers:
            continue
        p = TI.split_network_hetero_tp_circular(tn, S, V, tp)
        assert p.S == S and p.V == V and p.tp == tp
        assert tuple(p.packed.shape[:3]) == (S, V, tp)
        _roundtrip(JI.split_network_hetero_tp_circular(jn, S, V, tp), p, tn)


def test_describe_hetero_tp_partitions():
    """Both tensor-parallel kinds render the JAX package's text, character
    for character."""
    (jf, tf), (jy, ty) = (nets(784, 10, [(300, "logistic"),
                                         (100, "logistic")], "softmax", 0),
                          deep_pyramid())
    for jp, tp_ in ((JI.split_network_hetero_tp(jf, 2, 2),
                     TI.split_network_hetero_tp(tf, 2, 2)),
                    (JI.split_network_hetero_tp_circular(jy, 2, 2, 2),
                     TI.split_network_hetero_tp_circular(ty, 2, 2, 2))):
        assert TI.describe_partition(tp_) == JI.describe_partition(jp)
    s = TI.describe_partition(TI.split_network_hetero_tp(tf, 2, 2))
    assert "tp=2" in s and "(+replicated tail)" in s
    assert "1/2 per shard" in s
    s = TI.describe_partition(TI.split_network_hetero_tp_circular(ty, 2, 2,
                                                                  2))
    assert "heterogeneous circular x tp partition: 2 stages x 2 chunks" in s
    assert "tp=2" in s and "1/2 per shard" in s and "balance:" in s


def test_describe_hetero_tp_circular():
    jy, ty = deep_pyramid(5)
    assert TI.describe_partition(TI.split_network_hetero_tp_circular(
        ty, 2, 2, 2)) == JI.describe_partition(
        JI.split_network_hetero_tp_circular(jy, 2, 2, 2))


# ---------------------------------------------------------------------------
# fit on the (2, 2, 2) mesh
# ---------------------------------------------------------------------------


def _fit_pair(pair, loss, X, Y, **kw):
    """The JAX package's ``fit`` on one device and the port's on the (2, 2,
    2) mesh, the port's with no idle-model-axis warning.  (The JAX
    package's own tests hold its (2, 2, 2) runs to its one-device run at
    1e-9; its one-device run is the reference here, which keeps the JAX
    package's 3-D-mesh runs, whose collectives the CPU devices rendezvous
    for, out of the test run's load.)"""
    _, tm = meshes()
    jl, tl = (f(pair[1].out_shape[0]) for f in LOSSES[loss])
    jr = j_fit(pair[0], jl, JB, X, Y, optimizer=j_adam(),
               **{k: v for k, v in kw.items()
                  if not k.startswith("pipeline")})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = t_fit(pair[1], tl, TB, X, Y, mesh=tm, optimizer=t_adam(), **kw)
    assert not any("model axis" in str(x.message) for x in w)
    return jr, tr


def _close(a, b, atol=ATOL):
    assert a.steps == b.steps
    for ha, hb in zip(a.history, b.history):
        assert abs(ha["loss"] - hb["loss"]) <= atol, (ha, hb)
    for x, y in zip(a.net.params, b.net.params):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol,
                                   rtol=0)


def _resume_equal(pair, loss, X, Y, straight, tmp_path, **kw):
    """An epoch with checkpoints, resumed to two: bit-equal to ``straight``
    (the port's run of both epochs)."""
    _, tm = meshes()
    tl = LOSSES[loss][1](pair[1].out_shape[0])
    ck = str(tmp_path / "tp.npz")
    kw = dict(kw, mesh=tm, optimizer=t_adam(), checkpoint_path=ck,
              checkpoint_every=2)
    t_fit(pair[1], tl, TB, X, Y, epochs=1, **kw)
    resumed = t_fit(pair[1], tl, TB, X, Y, epochs=2, resume=True, **kw)
    assert resumed.steps == straight.steps
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@multi
def test_hetero_tp_fit(tmp_path):
    """fit on (2, 2, 2) with the pyramid: no idle-model warning, the loss
    curve and parameters equal the JAX package's one-device run at 1e-9; a
    checkpointed, resumed run equals the straight one bit for bit."""
    pair = pyramid(6)
    r = np.random.default_rng(5)
    X, Y = r.uniform(0, 1, size=(64, 16)), r.uniform(0, 1, size=(64, 16))
    kw = dict(batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=1, pipeline_microbatches=4)
    jr, tr = _fit_pair(pair, "sq", X, Y, epochs=2, **kw)
    _close(tr, jr)
    _resume_equal(pair, "sq", X, Y, tr, tmp_path, **kw)


@multi
def test_fit_hetero_tp_circular(tmp_path):
    """fit(pipeline_schedule='circular') on (2, 2, 2) with the deep
    pyramid: the tensor-parallel circular cut (no idle warning), equal to
    the JAX package's one-device run at 1e-9, resume exact."""
    pair = deep_pyramid(46)
    r = np.random.default_rng(45)
    X, Y = r.uniform(0, 1, size=(64, 24)), r.uniform(0, 1, size=(64, 24))
    kw = dict(batch_size=16, lr=0.01, verbose=False, prefetch=0,
              log_every=1, pipeline_microbatches=4,
              pipeline_schedule="circular", pipeline_chunks=2)
    jr, tr = _fit_pair(pair, "sq", X, Y, epochs=2, **kw)
    _close(tr, jr)
    _resume_equal(pair, "sq", X, Y, tr, tmp_path, **kw)


@multi
def test_hetero_tp_mixed_precision_and_accum(tmp_path):
    """bf16 on f32 masters trains to finite losses on (2, 2, 2); under
    (hetero tp x accum) the resumed run equals the straight one bit for
    bit, and the straight one the JAX package's one-device run at 1e-9."""
    pair = pyramid(33)
    r = np.random.default_rng(31)
    X, Y = r.uniform(0, 1, size=(64, 16)), r.uniform(0, 1, size=(64, 16))
    _, tm = meshes()
    _, tn = pyramid(32)
    n32 = type(tn)(tn.op, tuple(p.float() for p in tn.params), tn.act_names)
    res = t_fit(n32, t_sq(16), TorchBackend(torch.float32, "cpu"), X, Y,
                epochs=1, batch_size=16, lr=0.05, mixed_precision="bf16",
                pipeline_microbatches=2, mesh=tm, verbose=False, prefetch=0,
                log_every=1)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert all(p.dtype == torch.float32 for p in res.net.params)
    kw = dict(batch_size=16, lr=0.01, accum_steps=2, pipeline_microbatches=2,
              verbose=False, prefetch=0)
    jr, tr = _fit_pair(pair, "sq", X, Y, epochs=2, **kw)
    assert tr.steps == 8
    _close(tr, jr)
    _resume_equal(pair, "sq", X, Y, tr, tmp_path, **kw)


@multi
def test_hetero_circular_warns_idle_model_axis():
    """Odd widths cannot row-split: the circular partition runs replicated
    over the model axis, and says so, as the JAX package's partition does
    on its mesh; the losses equal the JAX package's one-device run."""
    pair = odd_pyramid(37)
    r = np.random.default_rng(38)
    X, Y = r.uniform(0, 1, size=(32, 24)), r.uniform(0, 1, size=(32, 24))
    jm, tm = meshes()
    kw = dict(epochs=1, batch_size=16, verbose=False, prefetch=0,
              pipeline_schedule="circular", pipeline_chunks=2,
              pipeline_microbatches=2, log_every=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        JI.make_ir_pipeline_loss(pair[0], j_sq(24), JB, jm, 2,
                                 schedule="circular", n_chunks=2)
    assert any("model axis" in str(x.message) for x in w)
    jr = j_fit(pair[0], j_sq(24), JB, X, Y, **{
        k: v for k, v in kw.items() if not k.startswith("pipeline")})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = t_fit(pair[1], t_sq(24), TB, X, Y, mesh=tm, **kw)
    assert any("model axis" in str(x.message) and "sit idle" in
               str(x.message) for x in w)
    _close(tr, jr)


# ---------------------------------------------------------------------------
# the cotangent's way through the model group, and kernel 9's calls
# ---------------------------------------------------------------------------


@multi
def test_gather_transpose_counts_each_cotangent_once(monkeypatch):
    """Every body segment's backward is its row-local op's ``transpose``
    (once per model rank and microbatch), and a loss whose transpose
    doubles its cotangent doubles every gradient: the post segments and
    the loss run once per data group, so the all-gather's transpose (a
    reduce-scatter) sums each cotangent into the model group once."""
    _, tn = nets(8, 4, [(16, "logistic")] * 5, "softmax", 3)
    tl = t_xent(4)
    x, y = _batch(8, 8, 4, seed=1, onehot=True)
    _, tm = meshes()
    M = 2
    loss_fn, pnet = TI.make_ir_pipeline_loss(tn, tl, TB, tm, M)
    _, gs = _seq(tn, tl, x, y)
    local = loss_fn.tp_local
    seen = collections.Counter()
    cls_b, cls_l = type(local), type(tl)
    real_b, real_l = cls_b.transpose, cls_l.transpose
    scale = [1.0]

    def counted(self, be, tape, cts):
        if self is local:
            seen["body"] += 1
        if self is tl:
            seen["loss"] += 1
            return tuple(scale[0] * c for c in real_l(self, be, tape, cts))
        return real_b(self, be, tape, cts)

    monkeypatch.setattr(cls_b, "transpose", counted)
    if cls_l is not cls_b:
        monkeypatch.setattr(cls_l, "transpose", counted)
    v1, g1 = loss_fn.value_and_grad(pnet.flat_params(), x, y)
    for a, b in zip(pnet.unflatten(g1).to_network_params(), gs):
        np.testing.assert_allclose(np.asarray(a), b, atol=ATOL, rtol=0)
    # 4 body segments x M microbatches x 2 model ranks on each of the 2
    # data groups (a vmapped transpose runs once a batch), the loss once
    # a data group
    assert seen == {"body": 4 * M * 2 * 2, "loss": 2}
    scale[0] = 2.0
    v2, g2 = loss_fn.value_and_grad(pnet.flat_params(), x, y)
    assert float(v2) == float(v1)
    for a, b in zip(g1, g2):
        np.testing.assert_array_equal(2 * np.asarray(a), np.asarray(b))


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


@multi
@pytest.mark.parametrize("shape,chain,sched,M,n_segs", [
    ((2, 2, 2), lambda: nets(8, 4, [(16, "logistic")] * 5, "softmax", 3),
     "gpipe", 2, 4),
    ((1, 2, 2), lambda: uniform_chain(8, 9, 1), "circular", 2, 8),
    ((1, 2, 4), lambda: nets(16, 4, [(8, "logistic")] * 2, "softmax", 2),
     "gpipe", 2, 3),
    ((2, 2, 2), lambda: deep_pyramid(1), "circular", 4, 8)])
def test_kernel9_calls_per_forward_and_gradient(shape, chain, sched, M,
                                                n_segs):
    _, tn = chain()
    x, y = _batch(8, tn.in_shape[0], tn.out_shape[0], seed=1, onehot=True)
    tm = TP.make_3d_pipeline_mesh(*shape, devices=["cpu"] * int(
        np.prod(shape)))
    loss_fn, pnet = TI.make_ir_pipeline_loss(tn, t_xent(tn.out_shape[0]),
                                             TB, tm, M, schedule=sched)
    specs = TI.pipelined_specs(pnet, tm)
    n_repl = sum(STAGE_AXIS not in s for s in specs)
    _, got_f = _counted(lambda: loss_fn.forward(pnet.flat_params(), x))
    _, got_g = _counted(lambda: loss_fn.value_and_grad(pnet.flat_params(),
                                                       x, y))
    # the smoke's prediction for phase 27, held here
    assert got_f == chip_smoke.irp_tp_predicted(shape, M, n_segs, len(specs),
                                                n_repl, False)
    assert got_g == chip_smoke.irp_tp_predicted(shape, M, n_segs, len(specs),
                                                n_repl, True)
