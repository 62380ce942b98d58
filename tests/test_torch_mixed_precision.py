"""``mixed_precision`` in the port's ``fit`` and ``fit_sequences``: the
ports of the mixed-precision cases of the JAX package's
``tests/test_trainer.py`` (the bf16 step on full-precision masters, the
measure-once router with its 3% hysteresis, its cache, its record in the
metrics JSONL and in ``.state``, the resume ladder, the legacy adoption),
one bf16 step held against the JAX package's bf16 step, and ``.state``
files that carry ``mp_route`` passing between the packages.

The bf16 tolerance.  Both packages compute the step's products in bf16
with f32 accumulation, rounded once to bf16, and every elementwise op in
bf16; they round the intermediate activations and cotangents at different
points (the JAX package's compiled step fuses elementwise chains), so a
gradient element may differ by a few bf16 roundings of 2**-8 relative
each.  Measured on this test's net: at most 1.2% of the leaf's largest
gradient (f64 masters), 0.6% (f32); the bound is four roundings of the
largest, 2**-6 = 1.56%, and the loss value equal."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu.models.trainer as JTR
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.models.trainer import make_opt_step as j_make_opt_step
import tensor_ops_tpu_torch.models.trainer as TR
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (act_logistic, act_softmax,
                                         cross_entropy, fit, fit_sequences,
                                         gen_net, squared_error)
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.feedforward import Network
from tensor_ops_tpu_torch.models.recurrent import gen_net as gen_rnet
from tensor_ops_tpu_torch.utils.checkpoint import load_meta
from torch_threads import one_torch_thread  # noqa: F401

TB = TorchBackend(torch.float64, "cpu")
BF16_TOL = 2.0 ** -6  # four bf16 roundings of the largest gradient


def toy_data(n, seed=0):
    """The JAX test's two-blob set: 2-d points, one-hot labels."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, 2, size=n)
    X = r.normal(size=(n, 2)) * 0.5 + np.where(labels[:, None] == 1, 1.0,
                                               -1.0)
    return X, np.eye(2)[labels], labels


def make_net(be, seed=0):
    return gen_net(be, 2, 2, [(8, act_logistic())], act_softmax(),
                   Rng(be, seed))


def sine_sequences(n=32, T_=8):
    t = np.linspace(0, 2 * np.pi, T_ + 1)
    XS = np.stack([np.sin(t[:-1] + p)[:, None] for p in np.linspace(0, 3, n)])
    TS = np.stack([np.sin(t[1:] + p)[:, None] for p in np.linspace(0, 3, n)])
    return XS, TS


def rnet(be, seed=3):
    return gen_rnet(be, 1, 1, [(8, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(be, seed))


def test_fit_mixed_precision():
    """bf16 compute with full-precision masters: converges, the masters
    keep the backend's dtype (f64 here), and the trajectory tracks the
    full-precision run within the JAX test's 0.15."""
    X, Y, _ = toy_data(240, seed=9)
    loss = cross_entropy(2)
    res_mp = fit(make_net(TB, seed=10), loss, TB, X, Y, epochs=6,
                 batch_size=40, lr=0.3, mixed_precision="bf16",
                 verbose=False, log_every=5)
    assert res_mp.history[-1]["loss"] < res_mp.history[0]["loss"]
    for p in res_mp.net.params:
        assert p.dtype == torch.float64
    res_fp = fit(make_net(TB, seed=10), loss, TB, X, Y, epochs=6,
                 batch_size=40, lr=0.3, verbose=False, log_every=5)
    assert abs(res_mp.history[-1]["loss"]
               - res_fp.history[-1]["loss"]) < 0.15
    with pytest.raises(ValueError, match="mixed_precision"):
        fit(make_net(NumpyBackend(), seed=10), loss, NumpyBackend(), X, Y,
            mixed_precision=True)


def test_mixed_precision_auto_routes_and_caches(tmp_path, monkeypatch):
    """``True`` routes on one measurement: a 2% bf16 win keeps f32 (the 3%
    hysteresis); the decision lands in the metrics JSONL and the .state
    checkpoint, is cached in-process (a second fit never measures), and a
    resume takes the recorded route without measuring."""
    X, Y, _ = toy_data(120, seed=11)
    loss = cross_entropy(2)
    calls = []

    def fake_measure(step_f32, step_bf16, args, **kw):
        calls.append(1)
        return 100.0, 98.0

    monkeypatch.setattr(TR, "_measure_mp_route", fake_measure)
    mpath, ck = str(tmp_path / "m.jsonl"), str(tmp_path / "c.npz")
    net = make_net(TB, seed=20)
    fit(net, loss, TB, X, Y, epochs=2, batch_size=40, lr=0.3,
        mixed_precision=True, verbose=False, metrics_path=mpath,
        checkpoint_path=ck, checkpoint_every=2, log_every=2)
    assert len(calls) == 1
    recs = [json.loads(line) for line in open(mpath)]
    assert recs[0]["mp_route"] == "f32"
    assert recs[0]["mp_f32_us"] == 100.0 and recs[0]["mp_bf16_us"] == 98.0
    assert load_meta(ck + ".state")["mp_route"] == "f32"
    fit(net, loss, TB, X, Y, epochs=1, batch_size=40, lr=0.3,
        mixed_precision=True, verbose=False)
    assert len(calls) == 1

    def boom(*a, **k):
        raise AssertionError("resume must not re-measure the route")

    monkeypatch.setattr(TR, "_decide_mp_route", boom)
    fit(make_net(TB, seed=20), loss, TB, X, Y, epochs=3, batch_size=40,
        lr=0.3, mixed_precision=True, verbose=False, checkpoint_path=ck,
        checkpoint_every=2, resume=True)


def test_mixed_precision_legacy_resume_adopts_bf16(tmp_path, monkeypatch):
    """Resuming a checkpoint with NO mp_route under ``True`` adopts bf16
    with a warning instead of measuring into a mid-chain dtype flip."""
    X, Y, _ = toy_data(80, seed=13)
    loss = cross_entropy(2)
    ck = str(tmp_path / "legacy.npz")
    fit(make_net(TB, seed=22), loss, TB, X, Y, epochs=2, batch_size=40,
        lr=0.3, verbose=False, checkpoint_path=ck, checkpoint_every=2)
    assert "mp_route" not in load_meta(ck + ".state")

    def boom(*a, **k):
        raise AssertionError("legacy resume must not measure")

    monkeypatch.setattr(TR, "_decide_mp_route", boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = fit(make_net(TB, seed=22), loss, TB, X, Y, epochs=3,
                  batch_size=40, lr=0.3, mixed_precision=True,
                  verbose=False, checkpoint_path=ck, checkpoint_every=2,
                  resume=True)
    assert any("no mp_route" in str(x.message) for x in w)
    assert load_meta(ck + ".state")["mp_route"] == "bf16"
    assert all(np.isfinite(h["loss"]) for h in res.history)


def test_normalize_mp_accepts_truthy_legacy_values():
    assert TR._normalize_mp(1) == "auto"
    assert TR._normalize_mp(0) == "off"
    assert TR._normalize_mp(np.True_) == "auto"
    assert TR._normalize_mp(np.False_) == "off"
    with pytest.raises(ValueError, match="mixed_precision"):
        TR._normalize_mp("yes")


def test_mixed_precision_auto_picks_bf16_when_clearly_faster(monkeypatch):
    """A >3% bf16 win routes to bf16, and the bf16 step runs (its key
    lands in the cache)."""
    X, Y, _ = toy_data(80, seed=12)
    monkeypatch.setattr(TR, "_measure_mp_route",
                        lambda *a, **k: (100.0, 90.0))
    net = make_net(TB, seed=21)
    res = fit(net, cross_entropy(2), TB, X, Y, epochs=2, batch_size=40,
              lr=0.3, mixed_precision=True, verbose=False, log_every=2)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert any(isinstance(k, tuple) and k and k[0] == "optstep" and k[5]
               for k in net.op._compiled), "the bf16 step was never built"


def test_mixed_precision_rejects_unknown_value():
    X, Y, _ = toy_data(40)
    with pytest.raises(ValueError, match="mixed_precision must be"):
        fit(make_net(TB), cross_entropy(2), TB, X, Y, mixed_precision="fp16")


def test_measure_times_both_routes_with_the_state_carried():
    """The measurement itself (the host clock here): both steps run,
    each on its own copy of the carried state, and the caller's state is
    untouched."""
    be = TorchBackend(torch.float32, "cpu")
    net = make_net(be, seed=1)
    opt = TO.adam()
    p0 = tuple(p.clone() for p in net.params)
    build = [TR.make_opt_step(net, cross_entropy(2), be, opt,
                              mixed_precision=m) for m in (False, True)]
    args = (torch.tensor(0.1), be.zeros((8, 2)), be.zeros((8, 2)),
            opt.init(net.params), net.params)
    f32_us, bf16_us = TR._measure_mp_route(*build, args, rounds=1, steps=3)
    assert f32_us > 0 and bf16_us > 0
    assert all(torch.equal(a, b) for a, b in zip(net.params, p0))


def test_fit_sequences_mixed_precision_auto_routes(monkeypatch):
    XS, TS = sine_sequences()
    calls = []

    def fake_measure(a, b, args, **kw):
        calls.append(kw.get("carry_from"))
        return 50.0, 10.0

    monkeypatch.setattr(TR, "_measure_mp_route", fake_measure)
    net = rnet(TB, seed=5)
    res = fit_sequences(net, squared_error(1), TB, XS, TS, epochs=2,
                        batch_size=16, rate_state=0.01, rate_param=0.1,
                        mixed_precision=True, log_every=1, verbose=False)
    assert calls == [4]
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert res.net.params[0].dtype == torch.float64
    assert any(isinstance(k, tuple) and k and k[0] == "seq_fit_step"
               and k[-4] for k in net.op._compiled)


def test_fit_sequences_mixed_precision_trains():
    """The bf16 scan-BPTT step trains (the loss falls) while the states and
    params stay full-precision masters, with and without an optimizer."""
    XS, TS = sine_sequences()
    for opt in (None, TO.adam()):
        res = fit_sequences(rnet(TB), squared_error(1), TB, XS, TS, epochs=8,
                            batch_size=16, rate_state=0.01, rate_param=0.1,
                            optimizer=opt, mixed_precision="bf16",
                            log_every=4, verbose=False)
        assert res.history[-1]["loss"] < res.history[0]["loss"]
        assert res.net.params[0].dtype == torch.float64
        assert res.net.states[0].dtype == torch.float64


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_bf16_step_matches_jax(dtype):
    """One bf16 sgd step of the port and of the JAX package from the same
    state: the loss equal, every gradient within BF16_TOL of its leaf's
    largest magnitude (see the module docstring)."""
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.float64, jnp.float64))
    JB, be = T.JaxBackend(dtype=jdt), TorchBackend(tdt, "cpu")
    jn = j_gen_net(JB, 12, 4, [(16, j_logistic()), (8, j_logistic())],
                   j_softmax(), JRng(JB, seed=3))
    tm = gen_net(be, 12, 4, [(16, act_logistic()), (8, act_logistic())],
                 act_softmax(), Rng(be, 0))
    tn = Network(tm.op, tuple(be.asarray(np.asarray(p)) for p in jn.params),
                 tm.act_names)
    r = np.random.default_rng(0)
    X, Y = r.uniform(0, 1, (32, 12)), np.eye(4)[r.integers(0, 4, 32)]
    jv, _, jp = j_make_opt_step(jn, j_xent(4), JB, JO.sgd(),
                                mixed_precision=True)(
        0.1, JB.asarray(X), JB.asarray(Y), (), jn.params)
    tv, _, tp = TR.make_opt_step(tn, cross_entropy(4), be, TO.sgd(),
                                 mixed_precision=True)(
        0.1, be.asarray(X), be.asarray(Y), (), tn.params)
    assert float(tv) == float(jv)
    for a, b, p0 in zip(tp, jp, jn.params):
        p0 = np.asarray(p0)
        ga, gb = (p0 - a.numpy()) / 0.1, (p0 - np.asarray(b)) / 0.1
        assert np.abs(ga - gb).max() <= BF16_TOL * np.abs(gb).max()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mp_route_state_passes_between_packages(writer, tmp_path,
                                                monkeypatch):
    """A ``.state`` recording ``mp_route`` from one package's fit resumes
    in the other's under ``mixed_precision=True``: the route is taken from
    the file, never measured."""
    X, Y, _ = toy_data(80, seed=14)
    ck = str(tmp_path / f"{writer}.npz")
    JB = T.JaxBackend(dtype=jnp.float64)
    jn = j_gen_net(JB, 2, 2, [(8, j_logistic())], j_softmax(),
                   JRng(JB, seed=2))
    tm = make_net(TB)
    tn = Network(tm.op, tuple(TB.asarray(np.asarray(p)) for p in jn.params),
                 tm.act_names)
    kw = dict(batch_size=40, lr=0.3, verbose=False, checkpoint_path=ck,
              checkpoint_every=2, mixed_precision=True)

    def boom(*a, **k):
        raise AssertionError("the route recorded in the file must be used")

    if writer == "jax":
        monkeypatch.setattr(JTR, "_measure_mp_route",
                            lambda *a, **k: (100.0, 50.0))
        j_fit(jn, j_xent(2), JB, X, Y, epochs=1, **kw)
        monkeypatch.setattr(TR, "_decide_mp_route", boom)
        res = fit(tn, cross_entropy(2), TB, X, Y, epochs=2, resume=True,
                  **kw)
    else:
        monkeypatch.setattr(TR, "_measure_mp_route",
                            lambda *a, **k: (100.0, 50.0))
        fit(tn, cross_entropy(2), TB, X, Y, epochs=1, **kw)
        monkeypatch.setattr(JTR, "_decide_mp_route", boom)
        res = j_fit(jn, j_xent(2), JB, X, Y, epochs=2, resume=True, **kw)
    assert load_meta(ck + ".state")["mp_route"] == "bf16"
    assert res.steps == 4 and res.history[0]["step"] == 3
    assert all(np.isfinite(h["loss"]) for h in res.history)
