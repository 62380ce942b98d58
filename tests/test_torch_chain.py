"""Step chaining in the port's ``fit`` (``chain_steps``), against the JAX
package's ``tests/test_chain.py``: one window of steps between observation
boundaries over the dataset held on the device, bit for bit the
step-at-a-time loop (``torch.equal``), and in host mode within 1e-9 of
the JAX package's chained ``fit`` in f64 on the same numpy data.

On the CPU a window runs the step eagerly; the card replays one CUDA
graph of it.  The graph path's bookkeeping (static buffers updated in
place, the scalar and row tables, the device step counter, the copy-in of
handed-in state) is exercised here by a stand-in for ``engine.capture``
whose "replay" calls the captured function again; a capture that fails
raises instead of running the window eagerly."""

import contextlib

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
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.utils.native import NativeLoader as JLoader
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (act_logistic, act_softmax,
                                         cross_entropy, gen_net)
from tensor_ops_tpu_torch import engine
from tensor_ops_tpu_torch.models import chain as C
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.feedforward import Network
from tensor_ops_tpu_torch.models.trainer import fit
from tensor_ops_tpu_torch.utils import checkpoint as TC
from tensor_ops_tpu_torch.utils import native as nat
from tensor_ops_tpu_torch.utils.native import NativeLoader
from torch_threads import one_torch_thread  # noqa: F401

TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()
JB = T.JaxBackend(dtype=jnp.float64)


def _mknet(be, seed=1):
    return gen_net(be, 16, 4, [(32, act_logistic())], act_softmax(),
                   Rng(be, seed))


def _data(n=530, seed=0):
    g = np.random.default_rng(seed)
    X = g.uniform(-1, 1, (n, 16)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[g.integers(0, 4, n)]
    return X, Y


def _equal(ps, qs):
    return all(torch.equal(a, b) for a, b in zip(ps, qs))


def _history(res):
    return [(r["step"], r["epoch"], r["loss"], r.get("val_acc"))
            for r in res.history]


@pytest.fixture
def graph_path(monkeypatch):
    """Run chained windows through ``StepChain``'s graph path on the CPU:
    ``capture`` warms the step up and returns a graph whose replay calls
    the captured function (what a CUDA graph replays)."""
    captured = []

    def fake_capture(fn, device, what="the training step", **kw):
        fn(False)
        captured.append(what)
        return type("Graph", (), {"replay": staticmethod(lambda: fn(True))})

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(engine, "capture", fake_capture)
    return captured


# ---------------------------------------------------------------------------
# index-mode loader: the chained stream IS the gathered stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [False, True])
def test_index_mode_matches_gathered_stream(drop_last):
    X, Y = _data(103)
    a = NativeLoader(X, Y, batch=16, seed=5, drop_last=drop_last)
    b = NativeLoader(X, Y, batch=16, seed=5, drop_last=drop_last,
                     index_mode=True)
    j = JLoader(X, Y, batch=16, seed=5, drop_last=drop_last, index_mode=True)
    for _ in range(30):  # crosses several epoch reshuffles
        xa, ya = a.next()
        idx = b.next_indices()
        assert np.array_equal(idx, j.next_indices())
        assert np.array_equal(xa, b.X[idx]) and np.array_equal(ya, b.Y[idx])
    for ld in (a, b, j):
        ld.close()


def test_index_mode_next_and_skip():
    X, Y = _data(103)
    a = NativeLoader(X, Y, batch=16, seed=9)
    b = NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    for _ in range(20):
        xa, ya = a.next()
        xb, yb = b.next()  # host gather from indices
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    c = NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    d = NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    c.skip(7)
    for _ in range(7):
        d.next_indices()
    for _ in range(10):
        assert np.array_equal(c.next_indices(), d.next_indices())
    for ld in (a, b, c, d):
        ld.close()


def test_index_mode_python_fallback(monkeypatch):
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    X, Y = _data(103)
    a = nat.NativeLoader(X, Y, batch=16, seed=5)
    b = nat.NativeLoader(X, Y, batch=16, seed=5, index_mode=True)
    assert not a.is_native and not b.is_native
    for _ in range(30):
        xa, ya = a.next()
        idx = b.next_indices()
        assert np.array_equal(xa, X[idx]) and np.array_equal(ya, Y[idx])


def test_next_indices_requires_index_mode():
    X, Y = _data(40)
    a = NativeLoader(X, Y, batch=8, seed=0)
    with pytest.raises(ValueError, match="index_mode"):
        a.next_indices()
    a.close()


# ---------------------------------------------------------------------------
# chained fit == unchained fit, bit for bit, and == the JAX chained fit
# ---------------------------------------------------------------------------

FULL = dict(epochs=3, batch_size=64, lr_schedule=JO.cosine_schedule(0.01, 27),
            ema_decay=0.9, accum_steps=2, clip_norm=0.5, log_every=7,
            verbose=False, seed=3)


def test_chained_equals_unchained_full_surface():
    """Ragged dataset, adam, clip, cosine schedule, EMA, accumulation and
    val: the chained run reproduces the step-at-a-time run exactly (params,
    EMA, every logged loss and val_acc), and the JAX package's chained run
    at 1e-9."""
    X, Y = _data(530)
    Xv, Yv = _data(64, seed=7)
    kw = dict(FULL, val=(Xv, np.argmax(Yv, axis=1)))
    jn = j_gen_net(JB, 16, 4, [(32, j_logistic())], j_softmax(),
                   JRng(JB, seed=4))

    def tnet():
        t = _mknet(TB)
        return Network(t.op, tuple(TB.asarray(np.asarray(p))
                                   for p in jn.params), t.act_names)

    r1 = fit(tnet(), cross_entropy(4), TB, X, Y, optimizer=TO.adam(),
             chain_steps=1, **kw)
    r2 = fit(tnet(), cross_entropy(4), TB, X, Y, optimizer=TO.adam(),
             chain_steps="auto", **kw)
    assert r1.steps == r2.steps == 27
    assert _equal(r1.net.params, r2.net.params)
    assert _equal(r1.ema_net.params, r2.ema_net.params)
    assert _history(r1) == _history(r2)
    j = j_fit(jn, j_xent(4), JB, X, Y, optimizer=JO.adam(),
              chain_steps="auto", **kw)
    assert [h["step"] for h in j.history] == [h["step"] for h in r2.history]
    for a, b in zip(r2.history, j.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-9
        assert a["val_acc"] == b["val_acc"]
    for a, b in zip(r2.net.params + r2.ema_net.params,
                    j.net.params + j.ema_net.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


def test_graph_path_equals_unchained_full_surface(graph_path):
    """The same run through the graph path's static buffers and tables
    (one capture, one replay a step) is bit for bit the unchained run."""
    X, Y = _data(530)
    kw = dict(FULL, optimizer=TO.adam())
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=1, **kw)
    before = C.chain_counts()["replays"]
    r2 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps="auto",
             **kw)
    assert len(graph_path) == 1
    # 27 steps, the 3 ragged epoch tails run eagerly
    assert C.chain_counts()["replays"] - before == 24
    assert _equal(r1.net.params, r2.net.params)
    assert _equal(r1.ema_net.params, r2.ema_net.params)
    assert _history(r1) == _history(r2)


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph"])
def test_chained_equals_unchained_adam8bit(graphs, request):
    """adam8bit with stochastic rounding: the noise is a hash of the step
    tensor, so the chained run (eager or through the graph path) draws the
    unchained run's noise."""
    if graphs:
        request.getfixturevalue("graph_path")
    X, Y = _data(512)
    kw = dict(epochs=2, batch_size=64, log_every=5, verbose=False, seed=1,
              ema_decay=0.5)
    opt = TO.adam8bit(stochastic_rounding=True, block=64)
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=1,
             optimizer=opt, **kw)
    r2 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps="auto",
             optimizer=opt, **kw)
    assert _equal(r1.net.params, r2.net.params)
    assert _equal(r1.ema_net.params, r2.ema_net.params)


def test_chain_cap_and_explicit_k():
    X, Y = _data(512)
    kw = dict(epochs=2, batch_size=64, optimizer=TO.sgd(), lr=0.05,
              log_every=8, verbose=False, seed=2)
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=1, **kw)
    r3 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=3, **kw)
    assert _equal(r1.net.params, r3.net.params)


def test_chain_validation():
    X, Y = _data(128)
    with pytest.raises(ValueError, match="chain_steps"):
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=0,
            verbose=False)
    with pytest.raises(ValueError, match="chain_steps"):
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps="always",
            verbose=False)
    with pytest.raises(ValueError, match="offload_opt_state"):
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=4,
            offload_opt_state=True, optimizer=TO.adam(), verbose=False)


def test_capture_failure_raises_and_never_runs_eagerly(monkeypatch):
    """A step that cannot be captured (here an optimizer that reads a
    value back to the host, which a capturing stream refuses) raises
    ``CaptureError`` naming the operation, and the run stops: the window
    is not run eagerly instead."""
    capturing = []

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, capture_error_mode="global"):
        capturing.append(True)
        try:
            yield
        finally:
            capturing.pop()

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    steps = []

    def update(state, params, grads, lr):
        steps.append(1)
        if capturing:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return (), tuple(p - lr * g for p, g in zip(params, grads))

    opt = TO.Optimizer(lambda params: (), update, "sync_sgd", hyper=())
    X, Y = _data(128)
    with pytest.raises(C.CaptureError, match="update") as info:
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, batch_size=32,
            optimizer=opt, verbose=False)
    assert "chain_steps=1" in str(info.value)
    assert steps == [1, 1]  # the warm-up, then the failed capture
    monkeypatch.setattr(engine, "uses_graphs", lambda device: False)
    assert fit(_mknet(TB), cross_entropy(4), TB, X, Y, batch_size=32,
               optimizer=opt, verbose=False).steps == 4


def test_graph_path_carries_a_host_counter_on_the_device(graph_path,
                                                        tmp_path):
    """A caller's optimizer that counts its steps in a Python int chains
    on the card as ``lax.scan`` carries it: the graph takes the int as a
    0-d tensor that each replay advances (not a constant frozen into the
    graph), and the run equals the unchained one."""
    def counting_sgd():
        def update(state, params, grads, lr):
            (n,) = state
            return (n + 1,), tuple(p - lr * g for p, g in zip(params, grads))

        return TO.Optimizer(lambda params: (0,), update, "counting_sgd",
                            hyper=())

    X, Y = _data(512)
    kw = dict(epochs=2, batch_size=64, lr=0.05, log_every=5, verbose=False,
              seed=4, checkpoint_every=16)
    cks = [str(tmp_path / f"{m}.npz") for m in ("one", "auto")]
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=1,
             optimizer=counting_sgd(), checkpoint_path=cks[0], **kw)
    before = C.chain_counts()["replays"]
    r2 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps="auto",
             optimizer=counting_sgd(), checkpoint_path=cks[1], **kw)
    assert len(graph_path) == 1
    assert C.chain_counts()["replays"] - before == 16
    assert _equal(r1.net.params, r2.net.params)
    for ck in cks:
        _, (n,), step = TC.load_train_state(ck + ".state", (0,))
        assert n == step == 16


def test_capture_holds_the_garbage_collector(monkeypatch):
    """No collection runs while a step is captured (a collection could
    destroy an unreachable graph, which invalidates a capture), and the
    collector is back on after it."""
    import gc

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, capture_error_mode="global":
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    seen = []
    assert gc.isenabled()
    engine.capture(lambda commit: seen.append((commit, gc.isenabled())), "cpu")
    assert seen == [(False, False), (True, False)] and gc.isenabled()


# ---------------------------------------------------------------------------
# exact resume across chained windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph"])
def test_chained_resume_bit_exact(graphs, request, tmp_path):
    """A chained run checkpointed mid-way and resumed equals the
    uninterrupted chained run: window boundaries are absolute step
    positions, so the resumed run cuts the same windows."""
    if graphs:
        request.getfixturevalue("graph_path")
    X, Y = _data(512)
    ck = str(tmp_path / "m.npz")
    kw = dict(batch_size=64, optimizer=TO.adam(), ema_decay=0.95,
              log_every=4, verbose=False, seed=5)
    full = fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=3, **kw)
    fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=2,
        checkpoint_path=ck, checkpoint_every=6, **kw)
    resumed = fit(_mknet(TB, seed=9), cross_entropy(4), TB, X, Y, epochs=3,
                  checkpoint_path=ck, checkpoint_every=6, resume=True, **kw)
    assert resumed.steps == full.steps == 24
    assert _equal(full.net.params, resumed.net.params)
    assert _equal(full.ema_net.params, resumed.ema_net.params)


def test_unchained_checkpoint_resumes_chained(tmp_path):
    X, Y = _data(512)
    ck = str(tmp_path / "m.npz")
    kw = dict(batch_size=64, optimizer=TO.adam(), log_every=4,
              verbose=False, seed=6)
    full = fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=3,
               chain_steps=1, **kw)
    fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=1, chain_steps=1,
        checkpoint_path=ck, checkpoint_every=8, **kw)
    resumed = fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=3,
                  chain_steps="auto", checkpoint_path=ck,
                  checkpoint_every=8, resume=True, **kw)
    assert resumed.steps == full.steps
    assert _equal(full.net.params, resumed.net.params)


# ---------------------------------------------------------------------------
# window planning: boundaries land where observation happens
# ---------------------------------------------------------------------------

def test_chained_history_and_checkpoint_cadence(tmp_path):
    X, Y = _data(512)  # 8 steps/epoch, no ragged tail
    ck1, ck2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    kw = dict(epochs=2, batch_size=64, optimizer=TO.sgd(), lr=0.1,
              log_every=5, checkpoint_every=6, verbose=False, seed=8)
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=1,
             checkpoint_path=ck1, **kw)
    r2 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps="auto",
             checkpoint_path=ck2, **kw)
    assert [r["step"] for r in r1.history] == [r["step"] for r in r2.history]
    assert TC.load_meta(ck1 + ".state")["step"] == \
        TC.load_meta(ck2 + ".state")["step"] == 12
    assert _equal(r1.net.params, r2.net.params)


def test_chain_backs_off_on_numpy_backend():
    X, Y = _data(128)
    r = fit(_mknet(TNB), cross_entropy(4), TNB, X, Y, epochs=1,
            batch_size=64, chain_steps="auto", log_every=1, verbose=False)
    assert r.steps == 2
