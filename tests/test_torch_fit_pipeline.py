"""The port's ``fit`` on a stage mesh (pipeline mode over the staged IR)
against the JAX package's, on the CPU in f64.

Each case runs the JAX package's ``fit`` on its 8 CPU devices and the
port's on a mesh of the same shape of ``["cpu"] * n`` ranks, from the same
parameters (drawn by the JAX package) and the same numpy data: losses and
returned parameters agree to 1e-9.  The JAX package's own assertions are
kept against the port's own runs (a pipeline against one device, a resumed
chain against the straight run, bit for bit where the port's steps are the
same), for GPipe, circular and heterogeneous partitions, ``accum_steps``,
bf16, the ZeRO ladder, ``offload_opt_state``, the ``.state`` layout string
and the ports of ``tests/test_fit_mesh.py``'s, ``tests/test_ir_pipeline.py``'s,
``tests/test_zero{1,2,3}.py``'s and ``tests/test_offload.py``'s pipeline
cases without a model axis."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu.parallel.pipeline as JP
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.ops.shapes import ShapeError
from tensor_ops_tpu_torch.parallel import pipeline as TP
from tensor_ops_tpu_torch.utils.checkpoint import (load_arrays,
                                                   network_from_arrays)
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
ACTS = {"logistic": (j_logistic, t_logistic), "softmax": (j_softmax,
                                                          t_softmax)}

multi = pytest.mark.skipif(len(jax.devices()) < 8,
                           reason="needs the 8-device CPU mesh")


def nets(i, o, hidden, out_act, seed):
    """``(jax net, port net)`` of one gen_net chain drawn by the JAX package
    from ``seed``, the port's graph holding its parameters."""
    jn = j_gen_net(JB, i, o, [(h, ACTS[a][0]()) for h, a in hidden],
                   ACTS[out_act][0](), JRng(JB, seed=seed))
    tmpl = t_gen_net(TB, i, o, [(h, ACTS[a][1]()) for h, a in hidden],
                     ACTS[out_act][1](), TRng(TB, 0))
    return jn, network_from_arrays(
        {f"param_{k}": np.asarray(p) for k, p in enumerate(jn.params)}, {},
        tmpl, TB)


def deep_uniform(seed):
    """9 hidden 16-wide layers: 8 identical body segments."""
    return nets(12, 2, [(16, "logistic")] * 9, "softmax", seed)


def flagship(seed):
    return nets(784, 10, [(300, "logistic"), (100, "logistic")], "softmax",
                seed)


def pyramid(seed):
    return nets(24, 24, [(w, "logistic") for w in (20, 16, 12, 8, 12, 16,
                                                   20)], "logistic", seed)


def square(seed, h=16):
    return nets(h, h, [(h, "logistic")] * 3, "logistic", seed)


def meshes(shape):
    """The JAX package's and the port's (CPU ranks) stage mesh."""
    n = int(np.prod(shape))
    if len(shape) == 1:
        return (JP.make_pipeline_mesh(*shape),
                TP.make_pipeline_mesh(*shape, devices=["cpu"] * n))
    return (JP.make_dp_pipeline_mesh(*shape),
            TP.make_dp_pipeline_mesh(*shape, devices=["cpu"] * n))


def classes(n, i, o, seed):
    r = np.random.default_rng(seed)
    return r.uniform(0, 1, size=(n, i)), np.eye(o)[r.integers(0, o, size=n)]


def targets(n, h, seed):
    r = np.random.default_rng(seed)
    return r.uniform(0, 1, size=(n, h)), r.uniform(0, 1, size=(n, h))


def opts(kw):
    """``kw``'s optimizer name as each package's optimizer."""
    name = kw.pop("opt", None)
    if name is None:
        return {}, {}
    return ({"optimizer": getattr(JO, name)()},
            {"optimizer": getattr(TO, name)()})


def both(pair, losses, X, Y, shape, **kw):
    """The JAX package's and the port's ``fit`` of one configuration on the
    stage mesh of ``shape`` (``None``: one device)."""
    jn, tn = pair
    jo, to = opts(kw)
    jm, tm = meshes(shape) if shape else (None, None)
    jr = j_fit(jn, losses[0], JB, X, Y, mesh=jm, **jo, **kw)
    tr = t_fit(tn, losses[1], TB, X, Y, mesh=tm, **to, **kw)
    return jr, tr


def assert_close(a, b, atol=ATOL):
    """Two fit results: their losses and returned parameters within
    ``atol`` (0: bit for bit)."""
    assert a.steps == b.steps
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert abs(ha["loss"] - hb["loss"]) <= atol, (ha, hb)
    for x, y in zip(a.net.params, b.net.params):
        if atol == 0:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=atol, rtol=0)


def single(pair, loss, X, Y, **kw):
    kw = {k: v for k, v in kw.items() if not k.startswith("pipeline")}
    _, to = opts(kw)
    return t_fit(pair[1], loss, TB, X, Y, **to, **kw)


# ---------------------------------------------------------------------------
# tests/test_fit_mesh.py's pipeline cases
# ---------------------------------------------------------------------------


@multi
def test_fit_pipeline_mesh_matches_single_device():
    """dp x pp (2, 4), adam, with validation: the port equals the JAX
    package's pipeline run and its own one-device run (the JAX test's
    bound); the returned net is the parameter stack and ``val`` ran."""
    X, Y = classes(128, 12, 2, seed=3)
    labels = np.argmax(Y[:40], axis=1)
    kw = dict(epochs=2, batch_size=32, lr=0.01, opt="adam", verbose=False,
              prefetch=0, log_every=2, val=(X[:40], labels))
    pair = deep_uniform(4)
    jr, tr = both(pair, (j_xent(2), t_xent(2)), X, Y, (2, 4),
                  pipeline_microbatches=4, **kw)
    assert_close(tr, jr)
    for a, b in zip(tr.history, jr.history):
        assert a["val_acc"] == b["val_acc"]
    sd = single(pair, t_xent(2), X, Y, **kw)
    assert tr.steps == sd.steps == 8
    assert all(isinstance(p, torch.Tensor) for p in tr.net.params)
    for a, b in zip(tr.net.params, sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


@multi
def test_fit_pipeline_mesh_resume(tmp_path):
    """On (8,): the servable checkpoint is the Network stack, a resumed
    chain equals the straight run bit for bit (and the JAX package's at
    1e-9), and a JAX ``.state`` file of the same layout resumes in the
    port."""
    X, Y = classes(128, 12, 2, seed=5)
    kw = dict(batch_size=32, lr=0.01, verbose=False, prefetch=0,
              pipeline_microbatches=4, checkpoint_every=4)
    pair = deep_uniform(6)
    jm, tm = meshes((8,))
    losses = (j_xent(2), t_xent(2))
    ck = str(tmp_path / "pp.npz")
    t_fit(pair[1], losses[1], TB, X, Y, epochs=1, mesh=tm,
          checkpoint_path=ck, optimizer=TO.adam(), **kw)
    _, meta = load_arrays(ck)
    assert meta["kind"] == "feedforward"
    resumed = t_fit(pair[1], losses[1], TB, X, Y, epochs=2, mesh=tm,
                    checkpoint_path=ck, resume=True, optimizer=TO.adam(),
                    **kw)
    jr, tr = both(pair, losses, X, Y, (8,), epochs=2, opt="adam", **kw)
    assert resumed.steps == tr.steps == 8
    for a, b in zip(resumed.net.params, tr.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert_close(tr, jr)
    # the JAX package's checkpoint of the first epoch, resumed by the port
    ckj = str(tmp_path / "ppj.npz")
    j_fit(pair[0], losses[0], JB, X, Y, epochs=1, mesh=jm,
          checkpoint_path=ckj, optimizer=JO.adam(), **kw)
    cross = t_fit(pair[1], losses[1], TB, X, Y, epochs=2, mesh=tm,
                  checkpoint_path=ckj, resume=True, optimizer=TO.adam(), **kw)
    for a, b in zip(cross.net.params, jr.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=0)


@multi
def test_fit_pipeline_mesh_ragged_dataset():
    X, Y = classes(140, 12, 2, seed=9)      # 140 % 32 != 0
    kw = dict(epochs=2, batch_size=32, lr=0.05, verbose=False, prefetch=0,
              pipeline_microbatches=4, log_every=1)
    jr, tr = both(deep_uniform(8), (j_xent(2), t_xent(2)), X, Y, (8,), **kw)
    assert tr.steps == 2 * (140 // 32)      # full batches only
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert_close(tr, jr)
    with pytest.raises(ValueError, match="at least one batch"):
        t_fit(deep_uniform(8)[1], t_xent(2), TB, X[:16], Y[:16], epochs=1,
              batch_size=32, verbose=False, mesh=meshes((8,))[1],
              pipeline_microbatches=4)


@multi
def test_fit_pipeline_accum_matches_plain():
    """2 accumulated half-batch chunks of 2 microbatches equal the whole
    batch of 4 (the port's own runs, 1e-9) and the JAX package's
    accumulated run."""
    X, Y = classes(128, 12, 2, seed=21)
    kw = dict(epochs=2, batch_size=32, lr=0.05, verbose=False, prefetch=0,
              log_every=1)
    pair = deep_uniform(13)
    jr, tr = both(pair, (j_xent(2), t_xent(2)), X, Y, (2, 4), accum_steps=2,
                  pipeline_microbatches=2, **kw)
    assert_close(tr, jr)
    plain = t_fit(pair[1], t_xent(2), TB, X, Y, mesh=meshes((2, 4))[1],
                  pipeline_microbatches=4, **kw)
    assert_close(tr, plain)


def test_fit_pipeline_accum_chunk_validated():
    X, Y = np.zeros((64, 12)), np.eye(2)[np.zeros(64, int)]
    with pytest.raises(ValueError, match="accumulation chunk"):
        t_fit(deep_uniform(0)[1], t_xent(2), TB, X, Y, batch_size=32,
              accum_steps=2, pipeline_microbatches=32,
              mesh=TP.make_pipeline_mesh(8, devices=["cpu"] * 8),
              verbose=False)
    with pytest.raises(ValueError, match="microbatch rows"):
        t_fit(deep_uniform(0)[1], t_xent(2), TB, X, Y, batch_size=32,
              pipeline_microbatches=4,
              mesh=TP.make_dp_pipeline_mesh(3, 2, devices=["cpu"] * 6),
              verbose=False)


@multi
def test_fit_pipeline_mixed_precision_and_accum_resume(tmp_path):
    """bf16 on f32 masters trains to finite, falling losses on (8,); a
    Ctrl-C-free crash/resume under (pipeline x accum) is bit-equal to the
    straight run, which equals the JAX package's at 1e-9: its one-device
    run, which the JAX package's own tests hold its (8,) pipeline to at
    1e-9.  (Its (8,) pipeline, nine ticks of an 8-device ring a microbatch
    grid, missed XLA's 40 s rendezvous termination timeout under the test
    run's load and aborted the worker running this test.)"""
    X, Y = classes(128, 12, 2, seed=23)
    mesh = meshes((8,))[1]
    tb32 = TorchBackend(torch.float32, "cpu")
    _, tn = deep_uniform(14)
    n32 = Network(tn.op, tuple(p.float() for p in tn.params), tn.act_names)
    res = t_fit(n32, t_xent(2), tb32, X, Y, epochs=1, batch_size=32, lr=0.05,
                mixed_precision="bf16", pipeline_microbatches=4, mesh=mesh,
                verbose=False, prefetch=0, log_every=1)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert all(p.dtype == torch.float32 for p in res.net.params)
    ck = str(tmp_path / "ppacc.npz")
    kw = dict(batch_size=32, lr=0.01, accum_steps=2,
              pipeline_microbatches=2, verbose=False, prefetch=0)
    pair = deep_uniform(15)
    t_fit(pair[1], t_xent(2), TB, X, Y, epochs=1, checkpoint_path=ck,
          checkpoint_every=2, mesh=mesh, optimizer=TO.adam(), **kw)
    resumed = t_fit(pair[1], t_xent(2), TB, X, Y, epochs=2,
                    checkpoint_path=ck, checkpoint_every=2, resume=True,
                    mesh=mesh, optimizer=TO.adam(), **kw)
    tr = t_fit(pair[1], t_xent(2), TB, X, Y, epochs=2, mesh=mesh,
               optimizer=TO.adam(), **kw)
    jr = j_fit(pair[0], j_xent(2), JB, X, Y, epochs=2, optimizer=JO.adam(),
               **{k: v for k, v in kw.items()
                  if not k.startswith("pipeline")})
    assert resumed.steps == tr.steps == 8
    for a, b in zip(resumed.net.params, tr.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert_close(tr, jr)


def test_async_checkpoint_copies_cpu_tensors(tmp_path):
    """``save_arrays_async`` copies a CPU tensor before it returns (its
    docstring's promise; ``.cpu().numpy()`` alone would share the tensor's
    memory): a change made after the call, while the one writer thread is
    still busy, does not reach the file."""
    import threading

    from tensor_ops_tpu_torch.utils import checkpoint as CKP

    t = torch.arange(6, dtype=torch.float64)
    path = str(tmp_path / "a.npz")
    CKP.save_arrays_async(str(tmp_path / "warm.npz"), {"w": t}).result()
    gate = threading.Event()
    busy = CKP._ASYNC_POOL.submit(gate.wait)
    fut = CKP.save_arrays_async(path, {"a": t}, {"step": 1})
    t.add_(100.0)
    gate.set()
    busy.result()
    fut.result()
    arrays, meta = CKP.load_arrays(path)
    np.testing.assert_array_equal(arrays["a"], np.arange(6.0))
    assert meta == {"step": 1}


@multi
def test_pipeline_resume_layout_mismatch_rejected(tmp_path):
    """A circular resume of a GPipe checkpoint (same leaf shapes, permuted
    rows) is refused by the layout string the port writes as the JAX
    package does."""
    X, Y = classes(64, 12, 2, seed=41)
    mesh = meshes((4,))[1]
    ck = str(tmp_path / "layout.npz")
    kw = dict(batch_size=16, lr=0.05, verbose=False, prefetch=0,
              pipeline_microbatches=4)
    _, tn = nets(12, 2, [(16, "logistic")] * 9, "softmax", 43)
    t_fit(tn, t_xent(2), TB, X, Y, epochs=1, mesh=mesh, checkpoint_path=ck,
          checkpoint_every=2, **kw)
    from tensor_ops_tpu_torch.utils.checkpoint import load_meta

    assert load_meta(ck + ".state")["layout"] == "pipeline:gpipe:S4"
    with pytest.raises(ValueError, match="layout"):
        t_fit(tn, t_xent(2), TB, X, Y, epochs=2, mesh=mesh,
              pipeline_schedule="circular", pipeline_chunks=2,
              checkpoint_path=ck, checkpoint_every=2, resume=True, **kw)


def test_pipeline_chunks_and_schedule_validated():
    _, tn = nets(12, 2, [(16, "logistic")] * 9, "softmax", 47)
    X, Y = np.zeros((32, 12)), np.eye(2)[np.zeros(32, int)]
    mesh = TP.make_pipeline_mesh(4, devices=["cpu"] * 4)
    with pytest.raises(ShapeError, match="n_chunks"):
        t_fit(tn, t_xent(2), TB, X, Y, batch_size=16, mesh=mesh,
              pipeline_schedule="circular", pipeline_chunks=0,
              verbose=False)
    with pytest.raises(ValueError, match="pipeline_schedule"):
        t_fit(tn, t_xent(2), TB, X, Y, batch_size=16, mesh=mesh,
              pipeline_schedule="1f1b", verbose=False)


@multi
def test_stage_mesh_with_a_model_axis_refused(monkeypatch):
    """A stage mesh with a model axis, refused before the tensor-parallel
    pipelines were ported, trains: on (1, 2, 2) the port's fit equals the
    JAX package's at 1e-9.  Under several processes a run without a mesh
    is refused, with the JAX package's reason (training in several
    processes runs since the port of Queue 1 item 9d:
    ``tests/test_torch_multihost.py``)."""
    X, Y = classes(64, 12, 2, seed=47)
    kw = dict(epochs=1, batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=1, pipeline_microbatches=2)
    pair = nets(12, 2, [(16, "logistic")] * 9, "softmax", 47)
    jm = JP.make_3d_pipeline_mesh(1, 2, 2)
    tm = TP.make_3d_pipeline_mesh(1, 2, 2, devices=["cpu"] * 4)
    jr = j_fit(pair[0], j_xent(2), JB, X, Y, mesh=jm, **kw)
    tr = t_fit(pair[1], t_xent(2), TB, X, Y, mesh=tm, **kw)
    assert_close(tr, jr)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="independent \\(divergent\\) "
                                         "replica per process"):
        t_fit(pair[1], t_xent(2), TB, X, Y, mesh=None, **kw)


# ---------------------------------------------------------------------------
# tests/test_ir_pipeline.py's fit cases
# ---------------------------------------------------------------------------


def _resume_equals(pair, loss, X, Y, straight, ck, **kw):
    """A run to half the budget, resumed to its end: bit-equal to
    ``straight``."""
    epochs = kw.pop("epochs")
    t_fit(pair[1], loss, TB, X, Y, epochs=epochs // 2, checkpoint_path=ck,
          checkpoint_every=2, optimizer=TO.adam(), **kw)
    resumed = t_fit(pair[1], loss, TB, X, Y, epochs=epochs,
                    checkpoint_path=ck, checkpoint_every=2, resume=True,
                    optimizer=TO.adam(), **kw)
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@multi
@pytest.mark.parametrize("form", ["hetero flagship", "circular",
                                  "hetero circular"])
def test_fit_pipeline_forms(tmp_path, form):
    """The heterogeneous flagship on (2, 3), the circular schedule on (4,)
    and the heterogeneous circular one on (2, 4): the JAX package's losses
    and parameters at 1e-9, one device's at 1e-9 (the JAX tests' bound),
    and an exact resume."""
    if form == "hetero flagship":
        pair, shape, sched = flagship(3), (2, 3), "gpipe"
        X, Y = classes(64, 784, 10, seed=7)
        losses = (j_xent(10), t_xent(10))
    elif form == "circular":
        pair, shape, sched = nets(12, 2, [(16, "logistic")] * 9, "softmax",
                                  21), (4,), "circular"
        X, Y = classes(64, 12, 2, seed=19)
        losses = (j_xent(2), t_xent(2))
    else:
        pair, shape, sched = pyramid(31), (2, 4), "circular"
        X, Y = targets(64, 24, seed=29)
        losses = (j_sq(24), t_sq(24))
    kw = dict(epochs=2, batch_size=16, lr=0.01, verbose=False, prefetch=0,
              log_every=1, pipeline_microbatches=4,
              pipeline_schedule=sched, pipeline_chunks=2)
    jr, tr = both(pair, losses, X, Y, shape, opt="adam", **kw)
    assert_close(tr, jr)
    assert_close(tr, single(pair, losses[1], X, Y, opt="adam", **kw))
    kw["mesh"] = meshes(shape)[1]
    _resume_equals(pair, losses[1], X, Y, tr, str(tmp_path / "f.npz"), **kw)


# ---------------------------------------------------------------------------
# the ZeRO ladder and offload on a pipeline (tests/test_zero{1,2,3}.py,
# tests/test_offload.py)
# ---------------------------------------------------------------------------


@multi
@pytest.mark.parametrize("zstage", [1, 2, 3])
def test_fit_zero_pipeline_mesh(zstage):
    """ZeRO-k on dp x pp (2, 4): the JAX package's ZeRO-k run and one
    device's at 1e-9; the leaves' moments (ZeRO-3: the leaves too) shard
    over the data axis."""
    X, Y = targets(64, 16, seed=6)
    kw = dict(epochs=1, batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=1, pipeline_microbatches=2)
    pair = square(5)
    jr, tr = both(pair, (j_sq(16), t_sq(16)), X, Y, (2, 4), opt="adam",
                  zero_stage=zstage, **kw)
    assert_close(tr, jr)
    assert_close(tr, single(pair, t_sq(16), X, Y, opt="adam", **kw))


@multi
def test_offload_pipeline_mesh():
    """offload_opt_state on (4,): bit-equal to the moments on the device,
    and the JAX package's offloaded run at 1e-9."""
    X, Y = targets(32, 16, seed=6)
    kw = dict(epochs=1, batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=1, pipeline_microbatches=2)
    pair = square(7)
    jr, off = both(pair, (j_sq(16), t_sq(16)), X, Y, (4,), opt="adam",
                   offload_opt_state=True, **kw)
    on = t_fit(pair[1], t_sq(16), TB, X, Y, mesh=meshes((4,))[1],
               optimizer=TO.adam(), **kw)
    assert_close(off, on, atol=0)
    assert_close(off, jr)


def test_pipeline_fit_leaves_each_layer_on_its_stage(tmp_path):
    """The returned net is the parameter stack with each layer's leaves
    where its stage trained them (a rank's device), and its checkpoint
    serves on one device."""
    from tensor_ops_tpu_torch.utils.checkpoint import load_network

    _, tn = deep_uniform(2)
    X, Y = classes(64, 12, 2, seed=1)
    ck = str(tmp_path / "st.npz")
    res = t_fit(tn, t_xent(2), TB, X, Y, batch_size=16, verbose=False,
                mesh=TP.make_pipeline_mesh(4, devices=["cpu"] * 4),
                checkpoint_path=ck, checkpoint_every=4)
    back = load_network(ck, tn, TB)
    assert len(res.net.params) == len(tn.params)
    for a, b in zip(back.params, res.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert os.path.exists(ck + ".state")


@multi
def test_fit_pipeline_val_loss_ema_and_clip():
    """``val_metric="loss"`` (each segment evaluated on its stage's rank),
    ``ema_decay`` and ``clip_norm`` (the norm's sums over the stage and data
    axes) on dp x pp at ZeRO-3: the JAX package's run at 1e-9, losses,
    validation losses, parameters and the EMA."""
    X, Y = targets(64, 16, seed=8)
    kw = dict(epochs=2, batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=2, pipeline_microbatches=2, zero_stage=3,
              ema_decay=0.9, clip_norm=0.5, val=(X[:24], Y[:24]),
              val_metric="loss")
    jr, tr = both(square(9), (j_sq(16), t_sq(16)), X, Y, (2, 4), opt="adam",
                  **kw)
    assert_close(tr, jr)
    for a, b in zip(tr.history, jr.history):
        assert abs(a["val_loss"] - b["val_loss"]) < ATOL
    for a, b in zip(tr.ema_net.params, jr.ema_net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=0)
