"""The port's ``fit`` on a mesh with a model axis against the JAX package's,
on the CPU in f64: the flagship at ``make_mesh(8)`` = ``(2, 4)`` (the loss
curve, the parameters and the returned specs, ``tests/test_fit_mesh.py:
70-97``, and adam with clip, ``:98``), the ZeRO ladder, ``offload_opt_state``
and ``adam8bit`` at ``(4, 2)`` (the meshes of ``tests/test_zero1.py``,
``test_zero2.py``, ``test_zero3.py``, ``test_offload.py`` and
``test_optim8bit.py:309``), the ``(1, 8)`` ZeRO no-op warning, the memory
report at ``(4, 2)`` leaf by leaf, ``.state`` files in both directions and
mixed precision on ``(2, 2)``.

Each case runs the port on ``make_mesh(n, shape=(dp, tp), devices=["cpu"] *
n)`` and the JAX package on a mesh of the same shape of its CPU devices,
from the same parameters (built by the JAX package) and the same numpy
data; losses, parameters, moments and EMA (the ``.state`` file each run
writes at its end) agree to 1e-9, and the port's single-device ``fit`` to
the same bound.  Each JAX run is shared by the cases that read it."""

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
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.parallel import mesh as JM
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu.utils.profiling import \
    training_memory_report as j_report
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.trainer import _mesh_setup, _moment_slots
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.parallel import mesh as TM
from tensor_ops_tpu_torch.utils import checkpoint as TC
from tensor_ops_tpu_torch.utils.profiling import \
    training_memory_report as t_report
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
FLAGSHIP = (784, 300, 100, 10)
SMALL = (16, 16, 16, 4)        # the ZeRO tests' net (h = 16)
ZMESH = (4, 2)


def jmesh(shape):
    return JM.make_mesh(shape[0] * shape[1], shape=shape)


def tmesh(shape):
    n = shape[0] * shape[1]
    return TM.make_mesh(n, shape=shape, devices=["cpu"] * n)


def jnet(widths=SMALL, seed=0):
    return j_gen_net(JB, widths[0], widths[-1],
                     [(h, j_logistic()) for h in widths[1:-1]], j_softmax(),
                     JRng(JB, seed=seed))


def tnet(jn, widths=SMALL):
    tmpl = t_gen_net(TB, widths[0], widths[-1],
                     [(h, t_logistic()) for h in widths[1:-1]], t_softmax(),
                     TRng(TB, 0))
    return Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                  for p in jn.params), tmpl.act_names)


def data(n=64, d=16, o=4, seed=1):
    r = np.random.default_rng(seed)
    return r.uniform(0, 1, size=(n, d)), np.eye(o)[r.integers(0, o, size=n)]


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def jspec(x, ndim):
    sh = getattr(x, "sharding", None)
    if not isinstance(sh, NamedSharding):
        return (None,) * ndim
    spec = tuple(sh.spec)
    return spec + (None,) * (ndim - len(spec))


def same_runs(got, want, atol=ATOL):
    assert len(got.history) == len(want.history) > 0
    for g, w in zip(got.history, want.history):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) <= atol, (g, w)
    for a, b in zip(got.net.params, want.net.params):
        if atol == 0:
            np.testing.assert_array_equal(host(a), host(b))
        else:
            np.testing.assert_allclose(host(a), host(b), atol=atol, rtol=0)
    if want.ema_net is not None:
        for a, b in zip(got.ema_net.params, want.ema_net.params):
            np.testing.assert_allclose(host(a), host(b), atol=atol, rtol=0)


def same_states(path_got, path_want, atol=ATOL):
    got, gm = TC.load_arrays(path_got)
    want, wm = JC.load_arrays(path_want)
    assert gm["step"] == wm["step"] and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].astype(np.float64),
                                   want[k].astype(np.float64), atol=atol,
                                   rtol=0, err_msg=k)


def run(pkg, tmp, shape, widths=SMALL, seed=3, X=None, Y=None, opt=None,
        tag="", **kw):
    """One package's mesh run, writing its ``.state`` at its last step."""
    if X is None:
        X, Y = data(d=widths[0], o=widths[-1])
    kw = dict(dict(epochs=2, batch_size=16, lr=0.05, verbose=False,
                   prefetch=0, log_every=1), **kw)
    steps = kw["epochs"] * -(-X.shape[0] // kw["batch_size"])
    j = pkg == "jax"
    O = JO if j else TO
    net = jnet(widths, seed) if j else tnet(jnet(widths, seed), widths)
    ck = str(tmp / f"{pkg}{tag}.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = (j_fit if j else t_fit)(
            net, (j_xent if j else t_xent)(widths[-1]), JB if j else TB, X,
            Y, mesh=(jmesh if j else tmesh)(shape),
            optimizer=getattr(O, opt[0])(**opt[1]) if opt else None,
            checkpoint_path=ck, checkpoint_every=steps, **kw)
    return res, ck + ".state"


def both(tmp, shape, atol=ATOL, **kw):
    """The JAX and the port's runs of one configuration, their ``.state``
    files and histories held to each other; returns (port, JAX)."""
    j, jpath = run("jax", tmp, shape, **kw)
    t, tpath = run("port", tmp, shape, **kw)
    same_states(tpath, jpath, atol)
    same_runs(t, j, atol)
    return t, j


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """tests/test_fit_mesh.py:70's run, both packages at make_mesh(8)."""
    X, Y = data(n=48, d=784, o=10)
    return X, Y, both(tmp_path_factory.mktemp("flagship"), (2, 4),
                      widths=FLAGSHIP, seed=0, X=X, Y=Y, lr=0.1)


def test_fit_make_mesh_8_flagship_matches_jax_and_single(flagship):
    """The flagship on (2, 4): the loss curve and parameters equal the JAX
    run and one device at 1e-9, and the parameters train sharded: the
    300-wide weight row-parallel, the 100- and 10-wide ones column-parallel
    (10 % 4: the preferred row falls back), as the JAX run's."""
    X, Y, (t, j) = flagship
    single = t_fit(tnet(jnet(FLAGSHIP, 0), FLAGSHIP), t_xent(10), TB, X, Y,
                   epochs=2, batch_size=16, lr=0.1, log_every=1,
                   verbose=False)
    assert len(single.history) > 3
    same_runs(t, single)
    specs = tuple(p.spec for p in t.net.params)
    assert specs[0] == ("model", None) and specs[1] == ("model",)
    assert specs[2] == (None, "model") and specs[4] == (None, "model")
    assert specs == tuple(jspec(p, len(s)) for p, s in
                          zip(j.net.params, specs))


def test_fit_make_mesh_8_adam_and_clip(tmp_path):
    """tests/test_fit_mesh.py:98: adam with the global-norm clip on (2, 4)
    equals the JAX run (moments included) and one device at 1e-9."""
    X, Y = data(n=32, d=784, o=10, seed=5)
    kw = dict(epochs=1, lr=0.01, clip_norm=1.0)
    t, _ = both(tmp_path, (2, 4), widths=FLAGSHIP, seed=2, X=X, Y=Y,
                opt=("adam", {}), **kw)
    single = t_fit(tnet(jnet(FLAGSHIP, 2), FLAGSHIP), t_xent(10), TB, X, Y,
                   batch_size=16, optimizer=TO.adam(), log_every=1,
                   verbose=False, **kw)
    same_runs(t, single)


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """The JAX package's adam runs at (4, 2) by ZeRO rung, with EMA and the
    clip (one run each, read by the cases below)."""
    tmp = tmp_path_factory.mktemp("ladder")
    out = {}
    for z in (0, 1, 2, 3):
        out[z] = run("jax", tmp, ZMESH, opt=("adam", {}), zero_stage=z,
                     ema_decay=0.9, clip_norm=0.5, tag=str(z))
    return tmp, out


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_ladder_at_4x2_matches_jax(ladder, stage):
    """Each ZeRO rung on (4, 2) (adam, EMA, clip) equals the JAX run at the
    same rung, moments and EMA included, and the port's replicated run, at
    1e-9; the params come back on their model specs (ZeRO-3: with the data
    axis on a free dimension)."""
    tmp, jruns = ladder
    t, tpath = run("port", tmp, ZMESH, opt=("adam", {}), zero_stage=stage,
                   ema_decay=0.9, clip_norm=0.5, tag=str(stage))
    j, jpath = jruns[stage]
    same_states(tpath, jpath)
    same_runs(t, j)
    same_runs(t, jruns[0][0])
    specs = tuple(p.spec for p in t.net.params)
    assert specs[0][0] == "model" and specs[2][1] == "model"
    assert ("data" in specs[0]) == (stage == 3)


@pytest.mark.parametrize("zstage", [0, 3])
def test_offload_at_4x2_matches_jax_and_is_bit_equal(ladder, zstage):
    """offload_opt_state on (4, 2) (and on ZeRO-3) equals the JAX offloaded
    run at 1e-9 and the same configuration without offload bit for bit
    (tests/test_offload.py:95)."""
    tmp, jruns = ladder
    kw = dict(opt=("adam", {}), zero_stage=zstage, ema_decay=0.9,
              clip_norm=0.5, offload_opt_state=True)
    t, _ = both(tmp, ZMESH, tag=f"off{zstage}", **kw)
    on, _ = run("port", tmp, ZMESH, tag=f"on{zstage}", **dict(
        kw, offload_opt_state=False))
    same_runs(t, on, atol=0)


def _adam8bit_data():
    r = np.random.default_rng(7)
    X = r.normal(size=(256, 16))
    W = r.normal(size=(16, 4))
    return X, np.eye(4)[np.argmax(X @ W, axis=1)]


def test_adam8bit_at_4x2_exact_and_banded(tmp_path):
    """tests/test_optim8bit.py:309 on (4, 2): exact_reduction at ZeRO-2 and
    3 bit-equal to the replicated adam8bit run (its state built from the
    whole leaves, gathered over both axes), the default reduce-scatter
    within 1e-3, and the exact ZeRO-3 run within the JAX test's 1e-3 of
    the JAX package's (the two sum each gradient in another order, which
    int8 block quantization amplifies)."""
    X, Y = _adam8bit_data()
    widths = (16, 32, 4)
    kw = dict(epochs=2, batch_size=64, lr=0.05, log_every=1, verbose=False,
              mesh=tmesh(ZMESH))

    def fit8(opt, **k):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return t_fit(tnet(jnet(widths, 3), widths), t_xent(4), TB, X, Y,
                         optimizer=opt, **kw, **k)

    rep = fit8(TO.adam8bit())
    for stage in (2, 3):
        same_runs(fit8(TO.adam8bit(exact_reduction=True), zero_stage=stage),
                  rep, atol=0)
        z = fit8(TO.adam8bit(), zero_stage=stage)
        for a, b in zip(z.net.params, rep.net.params):
            np.testing.assert_allclose(host(a), host(b), atol=1e-3, rtol=0)
    both(tmp_path, ZMESH, widths=widths, X=X, Y=Y, batch_size=64,
         opt=("adam8bit", {"exact_reduction": True}), zero_stage=3,
         atol=1e-3)


def test_zero_on_1x8_warns_and_trains():
    """tests/test_zero1.py:265: on (1, 8) the data axis has one rank, so
    ZeRO has nothing to shard: every rung warns and the run trains on
    the model axis."""
    X, Y = data(n=32)
    for kw, what in ((dict(shard_opt_state=True), "shard_opt_state"),
                     (dict(zero_stage=2), "zero_stage=2"),
                     (dict(zero_stage=3), "zero_stage=3")):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = t_fit(tnet(jnet(seed=10)), t_xent(4), TB, X, Y, epochs=1,
                        batch_size=16, optimizer=TO.adam(),
                        mesh=tmesh((1, 8)), verbose=False, log_every=1, **kw)
        assert any(what in str(x.message) for x in w)
        assert all(np.isfinite(h["loss"]) for h in res.history)
        assert res.net.params[0].spec == ("model", None)


def _jax_placed(stage, opt, shape, widths=SMALL):
    """The JAX package's placement of fit's mesh branch at ``stage``."""
    mesh = jmesh(shape)
    net = jnet(widths)
    specs = JM.param_specs(net.param_stack, mesh)
    params = tuple(jax.device_put(p, NamedSharding(mesh, s))
                   for p, s in zip(net.params, specs))
    if stage >= 3:
        params, _, _, _ = JM.zero3_param_place(params, mesh)
    state = opt.init(params)
    if stage >= 1:
        state, _ = JM.zero1_place(state, mesh)
    return params, state


def _bytes(x) -> int:
    return int(x.addressable_shards[0].data.nbytes)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_memory_report_at_4x2_leaf_by_leaf(opt, stage):
    """tests/test_utils.py:412 on (4, 2): each leaf's params, gradient and
    moment bytes in the port's placement equal the JAX package's placement
    (its shards on one device), the leaves' specs equal the JAX ones, and
    the port's report rows, their sums, equal the JAX package's report
    (the model axis counts in both: its report applies param_specs at
    tp > 1)."""
    mesh = tmesh(ZMESH)
    net = tnet(jnet())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params, state, pins = _mesh_setup(
            net.params, TM.param_specs(net.param_stack, mesh),
            getattr(TO, opt)(), mesh, TB, stage)
        j_params, j_state = _jax_placed(stage, getattr(JO, opt)(), ZMESH)
        j_grads, _ = _jax_placed(3 if stage >= 2 else 0, getattr(JO, opt)(),
                                 ZMESH)
    assert [p.spec for p in params] == [jspec(p, p.ndim) for p in j_params]
    gspecs = [gs or p.spec for gs, p in zip(
        pins["grad_constrain"].specs if pins["grad_constrain"]
        else [None] * len(params), params)]
    t_leaves = TM._tree_leaves(state)
    j_leaves = jax.tree.leaves(j_state)
    slots = _moment_slots(t_leaves, params)
    totals = {"params": 0, "grads": 0, "moments": 0}
    for i, p in enumerate(params):
        g_elems = int(np.prod(p.shape))
        for a, s in zip(gspecs[i], p.shape):
            g_elems //= {"model": 2, "data": 4}.get(a, 1)
        port = {"params": p.rank_nbytes(0), "grads": g_elems * 8,
                "moments": sum(x.rank_nbytes(0) for x, s in
                               zip(t_leaves, slots) if s == i)}
        jx = {"params": _bytes(j_params[i]), "grads": _bytes(j_grads[i]),
              "moments": sum(_bytes(x) for x, s in zip(j_leaves, slots)
                             if s == i)}
        assert port == jx, i
        for row in totals:
            totals[row] += port[row]
        for x, jl in ((x, jl) for x, jl, s in zip(t_leaves, j_leaves, slots)
                      if s == i):
            assert x.spec == jspec(jl, x.ndim)
    rep = t_report(net, optimizer=getattr(TO, opt)(), mesh=mesh,
                   zero_stage=stage)["per_device"]
    j_rep = j_report(jnet(), optimizer=getattr(JO, opt)(), mesh=jmesh(ZMESH),
                     zero_stage=stage)["per_device"]
    for key, row in (("params_bytes", "params"), ("grads_bytes", "grads"),
                     ("optimizer_bytes", "moments")):
        assert rep[key] == totals[row] == j_rep[key], key
    for r in range(8):
        assert sum(p.rank_nbytes(r) for p in params) == rep["params_bytes"]


def test_adam8bit_state_is_built_from_whole_leaves():
    """adam8bit's blocks ravel the whole leaf (the JAX package's: "the
    blocks carry no model-axis sharding"): its codes and scales are the
    whole leaves' on every model rank, and the report's rows equal each
    rank's bytes at every rung."""
    mesh = tmesh(ZMESH)
    net = tnet(jnet())
    for stage in (0, 1, 3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params, state, _ = _mesh_setup(
                net.params, TM.param_specs(net.param_stack, mesh),
                TO.adam8bit(), mesh, TB, stage)
        codes = [x for x in TM._tree_leaves(state) if x.shape]
        for x, p in zip(codes[::4], net.params):
            assert x.shape[0] == -(-p.numel() // 256)
            assert "model" not in x.spec
        rep = t_report(net, optimizer=TO.adam8bit(), mesh=mesh,
                       zero_stage=stage)["per_device"]
        for r in range(8):
            assert sum(x.rank_nbytes(r) for x in codes) \
                == rep["optimizer_bytes"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_files_at_4x2_pass_between_packages(tmp_path, writer):
    """A ZeRO-3 run on (4, 2) of one package stops at step 4; the other
    resumes its ``.state`` on its own (4, 2) mesh and ends where the
    writer's straight run ends, to 1e-9; the resumed leaves keep their
    specs."""
    X, Y = data()
    kw = dict(batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=1, zero_stage=3, ema_decay=0.9)
    ck = str(tmp_path / "x.npz")
    pk = {"jax": (j_fit, lambda: jnet(seed=3), jmesh(ZMESH), j_xent, JB,
                  JO.adam),
          "port": (t_fit, lambda: tnet(jnet(seed=3)), tmesh(ZMESH), t_xent,
                   TB, TO.adam)}
    reader = "port" if writer == "jax" else "jax"
    w_fit, w_net, w_mesh, w_xent, w_be, w_opt = pk[writer]
    r_fit, r_net, r_mesh, r_xent, r_be, r_opt = pk[reader]
    w_fit(w_net(), w_xent(4), w_be, X, Y, epochs=1, mesh=w_mesh,
          optimizer=w_opt(), checkpoint_path=ck, checkpoint_every=4, **kw)
    resumed = r_fit(r_net(), r_xent(4), r_be, X, Y, epochs=2, mesh=r_mesh,
                    optimizer=r_opt(), checkpoint_path=ck,
                    checkpoint_every=4, resume=True, **kw)
    straight = w_fit(w_net(), w_xent(4), w_be, X, Y, epochs=2, mesh=w_mesh,
                     optimizer=w_opt(), **kw)
    assert resumed.steps == straight.steps == 8
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_allclose(host(a), host(b), atol=ATOL, rtol=0)
    for a, b in zip(resumed.ema_net.params, straight.ema_net.params):
        np.testing.assert_allclose(host(a), host(b), atol=ATOL, rtol=0)
    t = resumed if reader == "port" else straight
    assert t.net.params[0].spec == ("model", "data")


def test_mixed_precision_on_2x2(tmp_path):
    """mixed_precision on (2, 2): "bf16" trains through the executor's
    bf16 form with f64 masters, within bf16's rounding of the f64 run;
    True measures both steps as the loop runs them and records the
    route."""
    import json

    X, Y = data()
    kw = dict(epochs=1, batch_size=16, optimizer=TO.adam(), verbose=False,
              log_every=1, mesh=tmesh((2, 2)), zero_stage=2)
    f64 = t_fit(tnet(jnet(seed=3)), t_xent(4), TB, X, Y, **kw)
    bf = t_fit(tnet(jnet(seed=3)), t_xent(4), TB, X, Y,
               mixed_precision="bf16", **kw)
    assert bf.net.params[0].dtype == torch.float64
    for a, b in zip(bf.history, f64.history):
        assert abs(a["loss"] - b["loss"]) < 2e-2 * abs(b["loss"])
    metrics = str(tmp_path / "m.jsonl")
    res = t_fit(tnet(jnet(seed=3)), t_xent(4), TB, X, Y,
                mixed_precision=True, metrics_path=metrics, **kw)
    with open(metrics) as f:
        route = [json.loads(line) for line in f if "mp_route" in line]
    assert route and route[0]["mp_route"] in ("f32", "bf16")
    assert all(np.isfinite(h["loss"]) for h in res.history)


def test_fit_verbose_prints_memory_line_at_4x2(capsys):
    """tests/test_zero1.py:279 on (4, 2): the verbose memory line."""
    X, Y = data(n=32)
    t_fit(tnet(jnet(seed=11)), t_xent(4), TB, X, Y, epochs=1, batch_size=16,
          optimizer=TO.adam(), mesh=tmesh(ZMESH), shard_opt_state=True,
          verbose=True, log_every=100)
    out = capsys.readouterr().out
    assert "training state/device:" in out and "(zero1)" in out


def _ag_shapes(fn):
    """``fn()`` with the per-rank input shape of each kernel-9 all-gather
    of more than one rank recorded."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    seen, real = [], CK._collective

    def spy(xs, phase, *a, **k):
        if phase == "ag" and len(xs) > 1:
            seen.append(tuple(xs[0].shape))
        return real(xs, phase, *a, **k)

    CK._collective = spy
    try:
        return fn(), seen
    finally:
        CK._collective = real


@pytest.mark.parametrize("metric", ["accuracy", "loss"])
def test_fit_1x4_returns_sharded_leaves_and_validates_on_the_mesh(metric):
    """A ``(1, 4)`` fit with ``val`` returns its trained leaves Sharded on
    their specs, each rank holding its block of the JAX run's array (the
    JAX fit returns sharded arrays); the validation runs through the
    mesh's forward: no all-gather of a leaf's blocks (only of activation
    blocks, 24 validation rows against batches of 8) and no gather onto
    one rank; losses and ``val_*`` equal the JAX run's at 1e-9."""
    X, Y = data(n=32)
    r = np.random.default_rng(9)
    Xv = r.uniform(0, 1, size=(24, 16))
    yv = (r.integers(0, 4, size=24) if metric == "accuracy"
          else np.eye(4)[r.integers(0, 4, size=24)])
    kw = dict(epochs=1, batch_size=8, lr=0.1, log_every=2, verbose=False,
              val=(Xv, yv), val_metric=metric)
    j = j_fit(jnet(seed=4), j_xent(4), JB, X, Y, mesh=jmesh((1, 4)), **kw)
    full_calls = []
    real_full = TM.Sharded.full
    TM.Sharded.full = lambda self: full_calls.append(self) or real_full(self)
    try:
        t, shapes = _ag_shapes(lambda: t_fit(
            tnet(jnet(seed=4)), t_xent(4), TB, X, Y, mesh=tmesh((1, 4)),
            **kw))
    finally:
        TM.Sharded.full = real_full
    key = "val_acc" if metric == "accuracy" else "val_loss"
    assert len(t.history) == len(j.history) == 3
    for g, w in zip(t.history, j.history):
        assert abs(g["loss"] - w["loss"]) <= ATOL
        assert abs(g[key] - w[key]) <= ATOL, (g, w)
    mesh = t.net.params[0].mesh
    for p, q in zip(t.net.params, j.net.params):
        assert isinstance(p, TM.Sharded) and p.spec == jspec(q, p.ndim)
        for r_, idx in p.blocks():
            np.testing.assert_allclose(p.shards[r_].numpy(),
                                       np.asarray(q)[idx], atol=ATOL, rtol=0)
        if p.mdim is not None:
            assert {tuple(x.shape) for x in p.shards} == {
                tuple(s // 4 if i == p.mdim else s
                      for i, s in enumerate(p.shape))}
    leaf_blocks = {tuple(x.shape) for p in t.net.params for x in p.shards}
    assert shapes and not leaf_blocks & set(shapes), shapes
    # activation blocks, the feature axis moved to the front: (h/tp, rows)
    assert all({8, 24} & set(s) for s in shapes), set(shapes)
    assert not full_calls and mesh.shape == {"data": 1, "model": 4}
