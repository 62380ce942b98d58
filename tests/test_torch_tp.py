"""The port's tensor-parallel executor (``tensor_ops_tpu_torch/parallel/
tp.py``) and the segment matching it runs on (``parallel/ir_pipeline.py``)
against the JAX package on the CPU in f64: the local segments keep the JAX
split's shapes, suffixes and values; forward and gradients on ``(1, 2)``,
``(1, 4)``, ``(2, 2)`` and ``(2, 4)`` meshes equal the single-device IR to
1e-9; a segment the split cannot take runs on gathered weights with one
warning; ``sharded_train_step`` and ``sharded_forward`` at ``make_mesh(8)``
equal the JAX functions (``tests/test_parallel.py:43-75``); and
``shard_fused`` + ``Predictor`` serve as ``tests/test_parallel.py:134``
holds the JAX package's, to 1e-6 in f32.  The port's ranks are CPU
devices, where kernel 9's wrappers take their plain versions."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.parallel import ir_pipeline as JIP
from tensor_ops_tpu.parallel import mesh as JM
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models.training import batched_run, make_mean_grads
from tensor_ops_tpu_torch.ops import prim as P
from tensor_ops_tpu_torch.parallel import ir_pipeline as TIP
from tensor_ops_tpu_torch.parallel import mesh as TM
from tensor_ops_tpu_torch.parallel import tp as TP
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
NARROW = (16, 32, 16, 8)      # the flagship's shape, narrowed
ODD = (16, 32, 6, 10)         # 6 and 10: neither divides by 4
ROWS = (16, 30, 16, 8)        # 30 % 4: two row-parallel layers in a row
FLAGSHIP = (784, 300, 100, 10)


def jnet(widths, seed=0):
    return j_gen_net(JB, widths[0], widths[-1],
                     [(h, j_logistic()) for h in widths[1:-1]], j_softmax(),
                     JRng(JB, seed=seed))


def tnet(jn, widths):
    tmpl = t_gen_net(TB, widths[0], widths[-1],
                     [(h, t_logistic()) for h in widths[1:-1]], t_softmax(),
                     TRng(TB, 0))
    return Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                  for p in jn.params), tmpl.act_names)


def tmesh(dp, tp):
    return TM.make_mesh(dp * tp, shape=(dp, tp), devices=["cpu"] * (dp * tp))


def data(widths, n=16, seed=1):
    r = np.random.default_rng(seed)
    return (r.uniform(0, 1, size=(n, widths[0])),
            np.eye(widths[-1])[r.integers(0, widths[-1], size=n)])


def whole(leaf_like, blocks, mesh):
    """The whole leaf from one model group's blocks (every data rank
    holding the same)."""
    dp = mesh.shape["data"]
    return TM.Sharded(leaf_like.spec, list(blocks) * dp, mesh,
                      leaf_like.shape).numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("widths", [NARROW, FLAGSHIP, ODD])
def test_local_segments_match_jax_split(widths, tp):
    """network_segments and the row-parallel split give the JAX package's
    segments, local stacks and suffixes, and the local segment and suffix
    compute the JAX ones' values on the same inputs (to 1e-12 absolute or
    relative: a few ulps of f64, whose last bits the host's libm sets)."""
    jn = jnet(widths)
    tn = tnet(jn, widths)
    j_segs = JIP.network_segments(jn)
    t_segs = TIP.network_segments(tn)
    assert len(j_segs) == len(t_segs) == len(widths) - 1
    r = np.random.default_rng(4)
    for (jop, jps), (top, tps) in zip(j_segs, t_segs):
        assert top.in_stack == jop.in_stack and len(tps) == len(jps)
        js = JIP._tp_local_segment_split(jop, tp)
        ts = TIP._tp_local_segment_split(top, tp)
        assert (js is None) == (ts is None)
        assert (JIP._tp_local_segment(jop, tp) is None) == (
            TIP._tp_local_segment(top, tp) is None)
        if js is None:
            continue
        (jl, jsuf), (tl, tsuf) = js, ts
        assert tl.in_stack == jl.in_stack and tl.out_stack == jl.out_stack
        assert (jsuf is None) == (tsuf is None)
        xs = [r.normal(size=s) for s in tl.in_stack]
        np.testing.assert_allclose(
            tl.apply(TB, tuple(TB.asarray(x) for x in xs))[0].numpy(),
            np.asarray(jl.apply(JB, tuple(jnp.asarray(x) for x in xs))[0]),
            atol=1e-12, rtol=1e-12)
        if tsuf is not None:
            assert tsuf.in_stack == jsuf.in_stack
            z = r.normal(size=tsuf.in_stack[0])
            np.testing.assert_allclose(
                tsuf.apply(TB, (TB.asarray(z),))[0].numpy(),
                np.asarray(jsuf.apply(JB, (jnp.asarray(z),))[0]),
                atol=1e-12, rtol=1e-12)


def test_flagship_plan_changes_layout_with_tp():
    """W2 (10, 100) is row-parallel at tp = 2 (a local affine and exp, then
    the all-gather and the softmax suffix) and column-parallel at tp = 4
    (the logits' partial sums all-reduced, then bias and softmax); 300 and
    100 put a row -> column pair first at both."""
    net = tnet(jnet(FLAGSHIP), FLAGSHIP)
    kinds = {}
    for tp in (2, 4):
        specs = TM.param_specs(net.param_stack, tmesh(1, tp))
        segs = TP.plan(net, specs, tp)
        kinds[tp] = [s.kind for s in segs]
        if tp == 2:
            assert segs[2].ops[1] is not None  # the softmax suffix
            assert segs[2].ops[0].out_stack == ((5,),)
        else:
            assert segs[2].ops[0].in_stack == ((25,), (10, 25))
    assert kinds == {2: ["row", "col", "row"], 4: ["row", "col", "col"]}


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("widths", [NARROW, ODD, ROWS])
def test_executor_matches_single_device(widths, shape):
    """One model group's forward, mean loss and every leaf's gradient
    (its blocks gathered) equal the single-device IR at 1e-9; every data
    rank's group computes the same."""
    tn = tnet(jnet(widths, 2), widths)
    mesh = tmesh(*shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ODD's replicated weight warns
        specs = TM.param_specs(tn.param_stack, mesh)
    X, Y = data(widths)
    xb, yb = TB.asarray(X), TB.asarray(Y)
    v0, g0 = make_mean_grads(tn, t_xent(widths[-1]), TB)(xb, yb, *tn.params)
    y0 = batched_run(tn, TB)(xb, *tn.params)
    placed = [TM.place(p, s, mesh) for p, s in zip(tn.params, specs)]
    tp = shape[1]
    for d, row in enumerate(mesh.devices):
        ex = TP.TpNetwork(tn, specs, row, TB)
        ps = [tuple(p.shards[d * tp + m] for p in placed) for m in range(tp)]
        v, g = ex.value_and_grad(t_xent(widths[-1]), xb, yb, ps)
        assert abs(float(v) - float(v0)) < ATOL
        for i, p in enumerate(placed):
            np.testing.assert_allclose(
                whole(p, [g[m][i] for m in range(tp)], mesh), g0[i].numpy(),
                atol=ATOL, rtol=0)
        np.testing.assert_allclose(ex.forward(xb, ps).numpy(), y0.numpy(),
                                   atol=ATOL, rtol=0)
    if widths == ODD and tp == 4:
        assert [s.kind for s in ex.segs] == ["row", "col", "replicated"]


def _odd_layer(i, o, seed):
    """A layer whose graph is no ffLayer: ``vecMat`` on an ``(i, o)``
    weight, then the bias and a softmax."""
    r = np.random.default_rng(seed)
    op = (P.first(P.vec_mat(i, o), rest=[(o,)]) >> P.add((o,))
          >> t_softmax()(o))
    return Network(op, (TB.asarray(r.normal(0, 0.5, size=(i, o))),
                        TB.asarray(r.normal(0, 0.5, size=(o,)))))


def test_non_matching_segment_runs_gathered_with_one_warning():
    """A segment the split cannot take runs on its weights all-gathered
    over the model axis: sharded_train_step on (2, 2) warns once for the
    network (not once per data rank or step) naming the segment, and
    equals one device at 1e-9; its leaves stay sharded."""
    base = t_gen_net(TB, 16, 16, [(32, t_logistic())], t_logistic(),
                     TRng(TB, 3))
    net = base.then(_odd_layer(16, 8, 5))
    mesh = tmesh(2, 2)
    X, Y = data((16, 8))
    xb, yb = TB.asarray(X), TB.asarray(Y)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        step = TM.sharded_train_step(net, t_xent(8), TB, mesh)
        v, new = step(0.2, xb, yb, *net.params)
        v, new = step(0.2, xb, yb, *new)
    msgs = [str(x.message) for x in w if "all-gathered" in str(x.message)]
    assert len(msgs) == 1 and "segment 2" in msgs[0]
    assert new[4].spec == ("model", None) and new[4].mdim == 0
    ps = net.params
    mg = make_mean_grads(net, t_xent(8), TB)
    for _ in range(2):
        v0, g = mg(xb, yb, *ps)
        ps = tuple(p - 0.2 * gi for p, gi in zip(ps, g))
    assert abs(float(v) - float(v0)) < ATOL
    for a, b in zip(new, ps):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL,
                                   rtol=0)


def _jax_small(seed):
    return j_gen_net(JB, 8, 4, [(16, j_logistic()), (8, j_logistic())],
                     j_softmax(), JRng(JB, seed=seed))


def test_sharded_train_step_matches_jax_at_make_mesh_8():
    """tests/test_parallel.py:43 at make_mesh(8) = (2, 4): one sharded SGD
    step equals the JAX package's sharded step and the single-device step
    at 1e-9; the new params keep their model specs."""
    jn = _jax_small(0)
    r = np.random.default_rng(1)
    X = r.uniform(0, 1, size=(16, 8))
    Y = np.eye(4)[r.integers(0, 4, size=16)]
    j_mesh = JM.make_mesh(8)
    j_step = JM.sharded_train_step(jn, j_xent(4), JB, j_mesh)
    jv, j_new = j_step(0.1, jnp.asarray(X), jnp.asarray(Y),
                       *JM.shard_network(jn, j_mesh).params)
    tn = tnet(jn, (8, 16, 8, 4))
    mesh = TM.make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "model": 4}
    tv, t_new = TM.sharded_train_step(tn, t_xent(4), TB, mesh)(
        0.1, TB.asarray(X), TB.asarray(Y), *TM.shard_network(tn, mesh).params)
    assert abs(float(tv) - float(jv)) < ATOL
    for a, b in zip(t_new, j_new):
        assert a.spec == tuple(b.sharding.spec) + (None,) * (
            a.ndim - len(b.sharding.spec))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=0)
    v0, g0 = make_mean_grads(tn, t_xent(4), TB)(TB.asarray(X), TB.asarray(Y),
                                                 *tn.params)
    assert abs(float(tv) - float(v0)) < ATOL
    for a, p, g in zip(t_new, tn.params, g0):
        np.testing.assert_allclose(np.asarray(a), (p - 0.1 * g).numpy(),
                                   atol=ATOL, rtol=0)


def test_sharded_forward_matches_jax_at_make_mesh_8():
    """tests/test_parallel.py:62 at make_mesh(8)."""
    jn = _jax_small(3)
    X = np.random.default_rng(4).uniform(0, 1, size=(16, 8))
    j_mesh = JM.make_mesh(8)
    jy = JM.sharded_forward(jn, JB, j_mesh)(
        jnp.asarray(X), *JM.shard_network(jn, j_mesh).params)
    tn = tnet(jn, (8, 16, 8, 4))
    mesh = TM.make_mesh(8, devices=["cpu"] * 8)
    ty = TM.sharded_forward(tn, TB, mesh)(TB.asarray(X), *tn.params)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ty.numpy(), batched_run(tn, TB)(
        TB.asarray(X), *tn.params).numpy(), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def served():
    """The JAX test's model (16 -> 32 -> 16 -> 8, seed 2), its FusedMLP in
    the port (f32) and the JAX package's sharded serving output."""
    from tensor_ops_tpu.models.fast import FusedMLP as JFused

    from tensor_ops_tpu_torch.models import FusedMLP

    jn = j_gen_net(JB, 16, 8, [(32, j_logistic()), (16, j_logistic())],
                   j_softmax(), JRng(JB, seed=2))
    jfm = JFused.from_network(jn)
    x = np.random.default_rng(3).uniform(0, 1, size=(8, 16)).astype(
        np.float32)
    j_out = np.asarray(JM.shard_fused(jfm, JM.make_mesh(8)).run_xla(x))
    fm = FusedMLP.from_numpy([np.asarray(w, np.float32) for w in jfm.weights],
                             [np.asarray(b, np.float32) for b in jfm.biases],
                             jfm.acts, jfm.softmax_out, device="cpu")
    return fm, x, j_out


@pytest.mark.parametrize("shape", [(2, 4), (1, 2), (2, 2), (1, 4)])
def test_shard_fused_tensor_parallel_serving(served, shape):
    """tests/test_parallel.py:134 on the port: shard_fused places the
    weights by the alternating specs; run_xla of the sharded model equals
    the unsharded model at 1e-6 in f32 and the JAX package's sharded
    serving; the Predictor detects the sharded weights and serves every
    bucket through them (the kernels' routes refuse sharded weights, so a
    bucket under xla_threshold proves the route)."""
    from tensor_ops_tpu_torch.models import Predictor

    fm, x, j_out = served
    sfm = TM.shard_fused(fm, tmesh(*shape))
    assert sfm.weights[0].spec == ("model", None)
    assert sfm.weights[1].spec == (None, "model")
    assert sfm.sharded and not fm.sharded
    ref = fm.run_xla(torch.as_tensor(x)).numpy()
    got = sfm.run_xla(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, j_out, atol=1e-6, rtol=0)
    p = Predictor(sfm, buckets=(1, 8))
    assert p._sharded and not Predictor(fm, buckets=(8,))._sharded
    np.testing.assert_allclose(p.predict(x), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.predict(x[0]), ref[0], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="sharded model"):
        sfm.run_fused_inference(torch.as_tensor(x))


def test_predictor_reload_switches_the_route_atomically(served):
    """reload swaps the model and its sharded flag in one assignment: an
    unsharded replacement turns the mesh route off, a sharded one back on,
    and each serves what its model computes."""
    from tensor_ops_tpu_torch.models import Predictor

    fm, x, _ = served
    sfm = TM.shard_fused(fm, tmesh(1, 2))
    p = Predictor(sfm, buckets=(8,), use_fused_kernel=False)
    ref = fm.run_xla(torch.as_tensor(x)).numpy()
    p.reload(fm)
    assert not p._sharded and p._serving[0] is fm
    np.testing.assert_allclose(p.predict(x), ref, atol=1e-6, rtol=0)
    p.reload(sfm)
    # the serving state: (model, backend, int8 stack, sharded, graphs);
    # the mesh route runs direct, so it holds no request graphs
    assert p._sharded and p._serving[0] is sfm and len(p._serving) == 5
    assert p._serving[4] is None
    np.testing.assert_allclose(p.predict(x), ref, atol=1e-6, rtol=0)
    bf = Predictor(sfm, buckets=(8,), dtype="bf16")
    assert bf._sharded and bf.model.weights[0].dtype == torch.bfloat16
    np.testing.assert_allclose(bf.predict(x), ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("width", [6, 5])
def test_bf16_activations_cross_kernel_9_exactly(width):
    """bf16 activations cross the all-gather as int32 words (an even
    width) or as f32 (an odd one), and the all-reduce in f32: the gather
    is bit for bit the concatenation, the sum the f32 sum rounded once."""
    r = np.random.default_rng(width)
    xs = [torch.as_tensor(r.normal(size=(3, width))).to(torch.bfloat16)
          for _ in range(4)]
    for g in TM._all_gather(xs, 1):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, torch.cat(xs, dim=1))
    want = sum(x.float() for x in xs).to(torch.bfloat16)
    for s in TP._sum(xs):
        assert s.dtype == torch.bfloat16 and torch.equal(s, want)


def test_bf16_executor_trains_close_to_f32():
    """The executor's bf16 form (compute=bfloat16: the mixed-precision
    step) gives the f64 gradients within bf16's rounding, upcast to f32."""
    tn = tnet(jnet(NARROW, 6), NARROW)
    mesh = tmesh(1, 2)
    specs = TM.param_specs(tn.param_stack, mesh)
    placed = [TM.place(p, s, mesh) for p, s in zip(tn.params, specs)]
    ps = [tuple(p.shards[m] for p in placed) for m in range(2)]
    X, Y = data(NARROW)
    xb, yb = TB.asarray(X), TB.asarray(Y)
    v0, g0 = make_mean_grads(tn, t_xent(8), TB)(xb, yb, *tn.params)
    ex = TP.TpNetwork(tn, specs, mesh.devices[0], TB, torch.bfloat16)
    v, g = ex.value_and_grad(t_xent(8), xb, yb, ps)
    assert v.dtype == torch.float32 and g[0][0].dtype == torch.float32
    assert abs(float(v) - float(v0)) < 2e-2 * abs(float(v0))
    for i, p in enumerate(placed):
        got = whole(p, [g[m][i].double() for m in range(2)], mesh)
        scale = np.abs(g0[i].numpy()).max()
        assert np.abs(got - g0[i].numpy()).max() < 5e-2 * scale


@pytest.mark.parametrize("placement", ["(2, 1)", "(1, 2)", "replicated"])
def test_predictor_counts_sharded_weights_as_jax_does(served, placement):
    """Predictor's mesh route follows the JAX condition: a weight counts as
    model-sharded only when its spec splits it over an axis of more than
    one rank.  ``shard_fused`` on (2, 1), and a model whose every weight
    ``param_specs`` replicates (widths 5 -> 7 -> 3 on (1, 2)), serve whole
    from rank 0's copy through the kernel routes; on (1, 2) the mesh
    route.  The flag equals the JAX package's ``_sharded`` on the same
    placement, and the predictions the unsharded model's."""
    from tensor_ops_tpu.models.fast import FusedMLP as JFused
    from tensor_ops_tpu.models.serve import Predictor as JPredictor

    from tensor_ops_tpu_torch.models import FusedMLP, Predictor

    fm, x, _ = served
    shape = {"(2, 1)": (2, 1), "(1, 2)": (1, 2), "replicated": (1, 2)}[
        placement]
    if placement == "replicated":
        jn = j_gen_net(JB, 5, 3, [(7, j_logistic())], j_softmax(),
                       JRng(JB, seed=4))
        jfm = JFused.from_network(jn)
        fm = FusedMLP.from_numpy(
            [np.asarray(w, np.float32) for w in jfm.weights],
            [np.asarray(b, np.float32) for b in jfm.biases], jfm.acts,
            jfm.softmax_out, device="cpu")
        x = x[:, :5]
    else:
        jfm = JFused.from_network(j_gen_net(
            JB, 16, 8, [(32, j_logistic()), (16, j_logistic())], j_softmax(),
            JRng(JB, seed=2)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JPredictor(JM.shard_fused(jfm, JM.make_mesh(
            shape[0] * shape[1], shape=shape)), buckets=(8,))
        sfm = TM.shard_fused(fm, tmesh(*shape))
    p = Predictor(sfm, buckets=(8,))
    assert p._serving[3] == jp._sharded == (placement == "(1, 2)")
    assert p._serving[0].sharded == p._serving[3]
    ref = fm.run_xla(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(p.predict(x), ref, atol=1e-6, rtol=0)
