"""The port's mesh (``tensor_ops_tpu_torch/parallel/mesh.py``) against the
JAX package's on the CPU: ``make_mesh``'s factoring and errors,
``param_specs`` at ``(2, 4)`` and ``(4, 1)``, the ZeRO rules leaf by leaf
(the port's spec of every leaf is the JAX package's ``NamedSharding`` spec),
``sharded_train_step`` and ``sharded_forward`` to 1e-9 in f64, the
sharded leaf and its collectives along any dimension (kernel 9's plain
versions on CPU ranks), a model axis > 1 in the entry points, and the
refusal of meshes the port does not train on (a stage axis: ROADMAP.md
Queue 1 item 9c)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.parallel import mesh as JM
from tensor_ops_tpu.utils.profiling import \
    training_memory_report as JP_report
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.trainer import _mesh_setup
from tensor_ops_tpu_torch.parallel import collective_kernels as CK
from tensor_ops_tpu_torch.parallel import mesh as TM
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
FLAGSHIP = (784, 300, 100, 10)
SMALL = (16, 16, 16, 4)


def jnet(widths=FLAGSHIP, seed=0):
    return j_gen_net(JB, widths[0], widths[-1],
                     [(h, j_logistic()) for h in widths[1:-1]], j_softmax(),
                     JRng(JB, seed=seed))


def tnet(jn, widths=FLAGSHIP):
    tmpl = t_gen_net(TB, widths[0], widths[-1],
                     [(h, t_logistic()) for h in widths[1:-1]], t_softmax(),
                     TRng(TB, 0))
    return Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                  for p in jn.params), tmpl.act_names)


@pytest.fixture(scope="module")
def flagship():
    """The flagship built once by the JAX package (seed 0) and its copy in
    the port, shared by the cases that read them (none changes them)."""
    jn = jnet()
    return jn, tnet(jn)


def tmesh(dp, tp=1):
    return TM.make_mesh(dp * tp, shape=(dp, tp), devices=["cpu"] * (dp * tp))


def jspec(x, ndim=None):
    """A JAX leaf's spec, one entry per dimension (None when it has no
    NamedSharding: XLA left it unannotated)."""
    sh = getattr(x, "sharding", x)
    ndim = x.ndim if ndim is None else ndim
    if not isinstance(sh, NamedSharding):
        return (None,) * ndim
    spec = tuple(sh.spec)
    return spec + (None,) * (ndim - len(spec))


def test_make_mesh_factoring_and_errors():
    """The JAX package's factoring ((n // tp, tp), tp the largest of 4, 2
    dividing n) and its over-ask error; an explicit list may repeat a
    device; no CUDA device and no list raises (never the CPU)."""
    for n in (1, 2, 3, 4, 6, 8):
        got = TM.make_mesh(n, devices=["cpu"] * n)
        want = JM.make_mesh(n)
        assert got.shape == dict(want.shape), n
    assert tmesh(4).shape == {"data": 4, "model": 1}
    assert tmesh(4).data_devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="requested 9 devices"):
        TM.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="requested 9 devices"):
        JM.make_mesh(9)
    with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) != device"):
        TM.make_mesh(4, shape=(3, 2), devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_mesh(4)


@pytest.mark.parametrize("shape", [(2, 4), (4, 1), (8, 1)])
def test_param_specs_match_jax(shape):
    """param_specs is a pure function of the shapes and the model-axis
    size: the JAX package's specs at (2, 4) (test_parallel.py:76) and at
    the data-only shapes, for the flagship and a deep uniform net."""
    n = shape[0] * shape[1]
    for widths in (FLAGSHIP, (12, 16, 16, 16, 2)):
        stack = jnet(widths).param_stack
        got = TM.param_specs(stack, tmesh(*shape))
        want = JM.param_specs(stack, JM.make_mesh(n, shape=shape))
        assert got == tuple(tuple(s) + (None,) * (len(p) - len(s))
                            for s, p in zip(want, stack))
    # the flagship at tp=4: rows of the 300-wide layer, columns of the rest
    specs = TM.param_specs(jnet().param_stack, tmesh(2, 4))
    assert specs[0] == ("model", None) and specs[2] == (None, "model")
    assert specs[4] == (None, "model")


def test_param_specs_warn_when_nothing_divides():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        specs = TM.param_specs(((13, 21),), tmesh(2, 4))
    assert specs[0] == (None, None)
    assert any("no dim divisible" in str(x.message) for x in w)


def _jax_placed(stage, opt, dp, net):
    """The JAX package's placement of ``fit``'s mesh branch at ``stage`` of
    the JAX network ``net``: the params (ZeRO-3: data-extended) and the
    optimizer state."""
    mesh = JM.make_mesh(dp, shape=(dp, 1))
    specs = JM.param_specs(net.param_stack, mesh)
    params = tuple(jax.device_put(p, NamedSharding(mesh, s))
                   for p, s in zip(net.params, specs))
    if stage >= 3:
        params, _, _, _ = JM.zero3_param_place(params, mesh)
        state = opt.init(params)
        if opt.name == "adam8bit":
            return params, None  # XLA's propagation: see the test below
    else:
        state = opt.init(params)
    if stage >= 1:
        state, _ = JM.zero1_place(state, mesh)
    return params, state


@pytest.mark.parametrize("dp", [4, 8])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("opt", ["adam", "momentum", "adam8bit"])
def test_zero_specs_match_jax_leaf_by_leaf(flagship, opt, stage, dp):
    """Every param and optimizer-state leaf the port places for ``fit`` on a
    (dp, 1) mesh at each ZeRO stage holds the JAX package's spec, adam8bit's
    ``(n_blocks, block)`` codes and ``(n_blocks, 1)`` scales included (at
    dp = 4 most flagship codes shard their block columns: n_blocks does not
    divide).  At ZeRO-3 the JAX package's adam8bit moments carry what XLA's
    propagation gives a reshaped sharded param (mostly unannotated); the
    port extends them by the ZeRO-1 rule, the rule the JAX package's
    memory report counts, so that case checks the params only."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_params, j_state = _jax_placed(stage, getattr(JO, opt)(), dp,
                                        flagship[0])
        mesh = tmesh(dp)
        net = flagship[1]
        params, state, pins = _mesh_setup(
            net.params, TM.param_specs(net.param_stack, mesh),
            getattr(TO, opt)(), mesh, TB, stage)
    assert [p.spec for p in params] == [jspec(p) for p in j_params]
    if j_state is not None:
        t_leaves = TM._tree_leaves(state)
        j_leaves = jax.tree.leaves(j_state)
        assert len(t_leaves) == len(j_leaves)
        for t, j in zip(t_leaves, j_leaves):
            if not getattr(j, "ndim", 0):
                assert t.spec == ()
                continue
            assert t.shape == j.shape
            assert t.spec == jspec(j), (t.shape, t.spec, jspec(j))
    if stage >= 2 and opt != "adam8bit":
        want = JM.zero2_grad_shardings(j_params if stage < 3 else tuple(
            jax.device_put(np.asarray(p), NamedSharding(
                JM.make_mesh(dp, shape=(dp, 1)), s)) for p, s in zip(
                flagship[0].params, JM.param_specs(
                    flagship[0].param_stack,
                    JM.make_mesh(dp, shape=(dp, 1))))),
            JM.make_mesh(dp, shape=(dp, 1)))
        got = pins["grad_constrain"].specs
        assert got == tuple(None if w is None else jspec(w, len(p.shape))
                            for w, p in zip(want, params))


# The leaves where the port's training_memory_report, which follows the
# placement fit makes, parts from the JAX package's report at model axis 1:
# that report skips param_specs there, so it divides b0 (300,) by dp where
# placement keeps b0's model entry and the leaf whole (and its gradient and
# moments with it); and it sizes adam8bit's (n_blocks, block) codes whole
# unless dp divides n_blocks, where placement shards their block columns
# (the flagship's W0, b0, W1, b1 and b2 have 919, 2, 118, 1 and 1 blocks of
# 256).  Each row of each other leaf must be the JAX report's.
FLAGSHIP_NAMES = ("W0", "b0", "W1", "b1", "W2", "b2")
REPORT_DIFFS = {"params": (3, {"b0"}), "grads": (2, {"b0"}),
                "moments": (1, {"b0"})}
CODES_DIFFS = {"W0", "b0", "W1", "b1", "b2"}


def _j_leaf_rows(shape, opt, stage, dp):
    """The JAX package's report of a lone leaf of ``shape`` (its rule runs
    leaf by leaf at model axis 1), batch row 0."""
    from types import SimpleNamespace

    from tensor_ops_tpu.utils.profiling import training_memory_report

    lone = SimpleNamespace(param_stack=[shape], params=[np.zeros(1)],
                           op=SimpleNamespace(in_stack=[(1,)]))
    return training_memory_report(lone, optimizer=opt, batch_size=0,
                                  mesh=JM.make_mesh(dp, shape=(dp, 1)),
                                  zero_stage=stage)["per_device"]


def _bytes(x) -> int:
    """A JAX leaf's bytes on its first device."""
    return int(x.addressable_shards[0].data.nbytes)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("opt", ["adam", "momentum", "adam8bit"])
def test_memory_report_against_jax_leaf_by_leaf(flagship, opt, stage):
    """training_memory_report on the flagship at (4, 1), leaf by leaf: each
    leaf's params, gradient and moment bytes in the port's placement equal
    the JAX package's placement (its shards on one device), and equal the
    JAX report's rule for that leaf except at the differences named above,
    where they must differ; the port's report rows are the sums.  At ZeRO-3
    adam8bit's moments are held to the JAX package's ZeRO-1 placement, the
    rule the port extends them by (test_zero_specs_match_jax_leaf_by_leaf)."""
    from tensor_ops_tpu_torch.models.trainer import _moment_slots
    from tensor_ops_tpu_torch.utils.profiling import training_memory_report

    dp = 4
    mesh = tmesh(dp)
    jn, net = flagship
    stack = [tuple(s) for s in net.param_stack]
    j_opt = getattr(JO, opt)()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params, state, pins = _mesh_setup(
            net.params, TM.param_specs(net.param_stack, mesh),
            getattr(TO, opt)(), mesh, TB, stage)
        j_params, j_state = _jax_placed(stage, j_opt, dp, jn)
        if j_state is None:
            j_state = _jax_placed(1, j_opt, dp, jn)[1]
        j_grads = _jax_placed(3 if stage >= 2 else 0, j_opt, dp, jn)[0]
        j_rows = [_j_leaf_rows(s, j_opt, stage, dp) for s in stack]
    gspecs = (pins["grad_constrain"].specs if pins["grad_constrain"]
              else (None,) * len(params))
    t_leaves = TM._tree_leaves(state)
    j_leaves = jax.tree.leaves(j_state)
    if opt == "adam8bit":
        t_groups = list(state[1])
        j_groups = [j_leaves[1 + 4 * i:5 + 4 * i] for i in range(len(stack))]
    else:
        slots = _moment_slots(t_leaves, params)
        t_groups = [[x for x, s in zip(t_leaves, slots) if s == i]
                    for i in range(len(stack))]
        j_groups = [[x for x, s in zip(j_leaves, slots) if s == i]
                    for i in range(len(stack))]
    totals = {"params": 0, "grads": 0, "moments": 0}
    for i, name in enumerate(FLAGSHIP_NAMES):
        whole = int(np.prod(stack[i])) * 8
        port = {"params": params[i].rank_nbytes(0),
                "grads": whole // dp if gspecs[i] else whole,
                "moments": sum(x.rank_nbytes(0) for x in t_groups[i])}
        j_placed = {"params": _bytes(j_params[i]),
                    "grads": _bytes(j_grads[i]),
                    "moments": sum(_bytes(x) for x in j_groups[i])}
        j_rule = {"params": j_rows[i]["params_bytes"],
                  "grads": j_rows[i]["grads_bytes"],
                  "moments": j_rows[i]["optimizer_bytes"]}
        for row in port:
            totals[row] += port[row]
            assert port[row] == j_placed[row], (name, row)
            first, names = REPORT_DIFFS[row]
            differs = stage >= first and name in names
            if row == "moments" and opt == "adam8bit":
                differs = stage >= 1 and name in CODES_DIFFS
            if differs:
                assert port[row] != j_rule[row], (name, row)
            else:
                assert port[row] == j_rule[row], (name, row)
    rep = training_memory_report(net, optimizer=getattr(TO, opt)(),
                                 mesh=mesh, zero_stage=stage)["per_device"]
    assert (rep["params_bytes"], rep["grads_bytes"],
            rep["optimizer_bytes"]) == (totals["params"], totals["grads"],
                                        totals["moments"])
    # the lone-leaf decomposition is the JAX package's whole report
    j_whole = JP_report(jn, optimizer=j_opt, batch_size=0,
                        mesh=JM.make_mesh(dp, shape=(dp, 1)),
                        zero_stage=stage)["per_device"]
    for key in ("params_bytes", "grads_bytes", "optimizer_bytes"):
        assert j_whole[key] == sum(r[key] for r in j_rows)


def test_pin_inherited_keeps_the_specs_it_finds():
    """pin_inherited over the ZeRO-3 adam state keeps each moment on the
    spec it holds (a whole leaf pinned goes back to its blocks), is None
    for a state with nothing on the data axis, and refuses a tree of
    another structure."""
    mesh = tmesh(4)
    net = tnet(jnet(SMALL), SMALL)
    state = {}
    for stage in (0, 3):
        _, state[stage], _ = _mesh_setup(
            net.params, TM.param_specs(net.param_stack, mesh), TO.adam(),
            mesh, TB, stage)
    assert TM.pin_inherited(state[0]) is None
    pin = TM.pin_inherited(state[3])
    leaves = TM._tree_leaves(state[3])
    assert pin.specs == tuple(x.spec if x.dim is not None else None
                              for x in leaves)
    assert any(sh is not None for sh in pin.specs)
    whole = TM._tree_unflatten(state[3], [
        TM.reshard(x, tuple(None if a == "data" else a for a in x.spec))
        for x in leaves])
    back = TM._tree_leaves(pin(whole))
    for a, b in zip(back, leaves):
        assert a.spec == b.spec
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="changed structure"):
        pin(state[3][:2])


def test_zero_rules_on_specs():
    """The rule itself: the first spec-free dimension dp divides; a model
    entry counts as used; scalars, empty and non-divisible leaves and
    leaves already on the data axis are left alone; the pins reshard."""
    mesh = tmesh(4)
    leaf = TM.place(torch.arange(24.).reshape(4, 6), ("model", None), mesh)
    assert TM._data_extended_sharding(leaf, mesh, 4) is None  # 6 % 4
    leaf = TM.place(torch.arange(32.).reshape(4, 8), ("model", None), mesh)
    assert TM._data_extended_sharding(leaf, mesh, 4) == ("model", "data")
    assert TM._data_extended_sharding(torch.zeros(()), mesh, 4) is None
    assert TM._data_extended_sharding(torch.zeros(0, 4), mesh, 4) is None
    assert TM._data_extended_sharding(3, mesh, 4) is None
    placed, unshard, cons, shs = TM.zero3_param_place((leaf,), mesh)
    assert placed[0].spec == ("model", "data") and shs == (placed[0].spec,)
    assert [x.shape for x in placed[0].shards] == [(4, 2)] * 4
    whole = unshard(placed)[0]
    assert whole.spec == ("model", None)
    np.testing.assert_array_equal(np.asarray(whole), np.asarray(leaf))
    assert cons(unshard(placed))[0].spec == ("model", "data")
    assert TM.pin_shardings((None,)) is None
    state, pin = TM.zero1_place((leaf, (leaf,)), mesh)
    assert [x.spec for x in TM._tree_leaves(state)] == [("model", "data")] * 2
    with pytest.raises(ValueError, match="changed structure"):
        pin((leaf,))


def test_sharded_leaf_and_collectives_along_any_dim():
    """place / reshard / np.asarray round trips; the reduce-scatter and
    all-gather along a dimension other than the leading one equal their
    definitions (the one-shot's plain version on CPU ranks, the ring's
    order); int8 codes gather as int32 words, bit for bit."""
    mesh = tmesh(4)
    r = np.random.default_rng(0)
    x = r.normal(size=(6, 8, 12))
    for spec in ((None, "data", None), (None, None, "data"), (None,) * 3):
        leaf = TM.place(x, spec, mesh)
        np.testing.assert_array_equal(np.asarray(leaf), x)
        whole = TM.reshard(leaf, (None,) * 3)
        assert all(np.array_equal(s.numpy(), x) for s in whole.shards)
    xs = [torch.as_tensor(r.normal(size=(6, 8))) for _ in range(4)]
    total = sum(xs)
    out = CK.ring_reduce_scatter(xs, scale=0.25, dim=1)
    for k, o in enumerate(out):
        np.testing.assert_allclose(o.numpy(), 0.25 * total[:, 2 * k:2 * k + 2]
                                   .numpy(), atol=1e-15)
    mean = TM.reduce_mean(xs, (None, "data"), mesh)
    for a, b in zip(mean.shards, out):
        assert torch.equal(a, b)
    back = CK.ring_all_gather(out, dim=1)
    for b in back:
        np.testing.assert_allclose(b.numpy(), 0.25 * total.numpy(),
                                   atol=1e-15)
    codes = torch.as_tensor(r.integers(-127, 128, size=(5, 256)),
                            dtype=torch.int8)
    for spec in (("data", None), (None, "data")):
        if spec[0] and 5 % 4:
            continue
        leaf = TM.place(codes, spec, mesh)
        whole = TM.reshard(leaf, (None, None))
        assert all(torch.equal(s, codes) for s in whole.shards)
    assert (2 * TM.place(x, (None, "data", None), mesh)
            + TM.place(x, (None, "data", None), mesh)).numpy().tolist() \
        == (3 * x).tolist()


def test_sharded_train_step_matches_jax_and_single():
    """test_parallel.py:43 at (4, 1): three sharded SGD steps equal the JAX
    package's sharded step and the single-device mean-gradient step."""
    from tensor_ops_tpu.models.training import make_vmapped_grads  # noqa

    widths = SMALL
    jn = jnet(widths, 1)
    r = np.random.default_rng(2)
    X = r.uniform(0, 1, size=(32, 16))
    Y = np.eye(4)[r.integers(0, 4, size=32)]
    j_mesh = JM.make_mesh(4, shape=(4, 1))
    j_step = JM.sharded_train_step(jn, j_xent(4), JB, j_mesh)
    j_params = JM.shard_network(jn, j_mesh).params
    mesh = tmesh(4)
    tn = tnet(jn, widths)
    t_step = TM.sharded_train_step(tn, t_xent(4), TB, mesh)
    t_params = TM.shard_network(tn, mesh).params
    for _ in range(3):
        jv, j_params = j_step(0.3, jnp.asarray(X), jnp.asarray(Y), *j_params)
        tv, t_params = t_step(0.3, TB.asarray(X), TB.asarray(Y), *t_params)
    assert abs(float(tv) - float(jv)) < ATOL
    for a, b in zip(t_params, j_params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=0)
    # against the single-device step on the same batch
    from tensor_ops_tpu_torch.models.training import make_mean_grads

    ps = tuple(tnet(jn, widths).params)
    mg = make_mean_grads(tn, t_xent(4), TB)
    for _ in range(3):
        _, g = mg(TB.asarray(X), TB.asarray(Y), *ps)
        ps = tuple(p - 0.3 * gi for p, gi in zip(ps, g))
    for a, b in zip(t_params, ps):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL,
                                   rtol=0)


def test_sharded_forward_matches_jax_and_single():
    """test_parallel.py:62 at (4, 1)."""
    jn = jnet(SMALL, 4)
    X = np.random.default_rng(3).uniform(size=(16, 16))
    j_mesh = JM.make_mesh(4, shape=(4, 1))
    jy = JM.sharded_forward(jn, JB, j_mesh)(
        jnp.asarray(X), *JM.shard_network(jn, j_mesh).params)
    tn = tnet(jn, SMALL)
    ty = TM.sharded_forward(tn, TB, tmesh(4))(TB.asarray(X), *tn.params)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    single = np.stack([tn.run(TB, TB.asarray(x)).numpy() for x in X])
    np.testing.assert_allclose(ty.numpy(), single, atol=ATOL, rtol=0)


def test_model_axis_and_foreign_meshes_are_refused():
    """A model axis, refused before it was ported, now runs in every entry
    point that trains or serves on a mesh: sharded_train_step and
    sharded_forward on (2, 2) equal one device.  So does a mesh with a
    stage axis, refused before the 3-D mesh's partitions were ported: as
    the JAX package's param_specs leave them, the leaves replicate over the
    stage axis, and on (2, 2, 2) the step and the forward equal the JAX
    package's on its 3-D mesh.  A mesh that is not the port's is
    refused."""
    from tensor_ops_tpu_torch.models.training import (batched_run,
                                                      make_mean_grads)

    tn = tnet(jnet(SMALL), SMALL)
    r = np.random.default_rng(5)
    X = TB.asarray(r.uniform(size=(8, 16)))
    Y = TB.asarray(np.eye(4)[r.integers(0, 4, size=8)])
    v, new = TM.sharded_train_step(tn, t_xent(4), TB, tmesh(2, 2))(
        0.3, X, Y, *tn.params)
    v0, g0 = make_mean_grads(tn, t_xent(4), TB)(X, Y, *tn.params)
    assert abs(float(v) - float(v0)) < ATOL
    for a, p, g in zip(new, tn.params, g0):
        np.testing.assert_allclose(np.asarray(a), (p - 0.3 * g).numpy(),
                                   atol=ATOL, rtol=0)
    y = TM.sharded_forward(tn, TB, tmesh(2, 2))(X, *tn.params)
    np.testing.assert_allclose(y.numpy(), batched_run(tn, TB)(
        X, *tn.params).numpy(), atol=ATOL, rtol=0)

    import tensor_ops_tpu.parallel.pipeline as JP
    from tensor_ops_tpu_torch.parallel.pipeline import make_3d_pipeline_mesh

    jn = jnet(SMALL, seed=2)
    tn = tnet(jn, SMALL)
    for shape in ((2, 2, 2), (1, 2, 1)):
        jm = JP.make_3d_pipeline_mesh(*shape)
        tm = make_3d_pipeline_mesh(*shape, devices=["cpu"] * int(
            np.prod(shape)))
        jv, jnew = JM.sharded_train_step(jn, j_xent(4), JB, jm)(
            0.3, JB.asarray(np.asarray(X)), JB.asarray(np.asarray(Y)),
            *JM.shard_network(jn, jm).params)
        v, new = TM.sharded_train_step(tn, t_xent(4), TB, tm)(
            0.3, X, Y, *TM.shard_network(tn, tm).params)
        assert abs(float(v) - float(jv)) < ATOL
        for a, b in zip(new, jnew):
            assert "stage" not in a.spec
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=ATOL, rtol=0)
            # rank 0's copy and stage 1's (data 0, model 0) stay equal
            assert torch.equal(a.shards[0], a.shards[shape[2]])
        y = TM.sharded_forward(tn, TB, tm)(X, *tn.params)
        jy = JM.sharded_forward(jn, JB, jm)(JB.asarray(np.asarray(X)),
                                           *jn.params)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=0)
    from tensor_ops_tpu_torch.models import FusedMLP

    fm = FusedMLP.from_network(tn)
    sf = TM.shard_fused(fm, tm)
    np.testing.assert_allclose(sf.run_xla(X).numpy(), fm.run_xla(X).numpy(),
                               atol=ATOL, rtol=0)
    for fn in (lambda m: TM.sharded_train_step(tn, t_xent(4), TB, m),
               lambda m: TM.sharded_forward(tn, TB, m),
               lambda m: TM.shard_network(tn, m),
               lambda m: TM.shard_fused(fm, m)):
        with pytest.raises(ValueError, match="parallel.Mesh"):
            fn(JM.make_mesh(4, shape=(4, 1)))


@pytest.mark.parametrize("spec", [("data", "model"), ("model", None),
                                  (None, "data"), (None, None)])
def test_full_gathers_onto_rank_0_only_and_sharded_nets_save(tmp_path, spec):
    """``Sharded.full()`` copies each block to rank 0's device once (no
    kernel-9 call, no copy on any other rank); ``np.asarray`` of a leaf
    and ``save_network`` of a net of Sharded leaves write whole arrays,
    which the JAX package's loader reads back."""
    from tensor_ops_tpu.utils import checkpoint as JCK
    from tensor_ops_tpu_torch.utils import checkpoint as TCK

    r = np.random.default_rng(3)
    whole = r.normal(size=(4, 6))
    leaf = TM.place(whole, spec, tmesh(2, 2))
    calls = []
    real = CK._collective
    CK._collective = lambda xs, *a, **k: calls.append(a) or real(xs, *a, **k)
    try:
        got = leaf.full()
    finally:
        CK._collective = real
    assert not calls and got.device == leaf.shards[0].device
    np.testing.assert_array_equal(got.numpy(), whole)
    np.testing.assert_array_equal(np.asarray(leaf), whole)

    jn = jnet(SMALL)
    tn = tnet(jn, SMALL)
    sharded = TM.shard_network(tn, tmesh(2, 2))
    p = str(tmp_path / "net.npz")
    TCK.save_network(p, sharded)
    back = JCK.load_network(p, jn, JB)
    for a, b in zip(back.params, tn.params):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
