"""Step chaining in the port's ``fit_sequences``, the port of the JAX
package's ``tests/test_seq_chain.py``: host mode equals the unchained run
bit for bit (states, params, EMA and logged losses) and the JAX package's
chained ``fit_sequences`` at 1e-9 in f64; the device modes are pure
functions of (seed, absolute step), held by their properties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.models.recurrent import gen_net as j_gen_rnet
from tensor_ops_tpu.models.trainer import fit_sequences as j_fit_seq
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import act_logistic, squared_error
from tensor_ops_tpu_torch import engine
from tensor_ops_tpu_torch.models import chain as C
from tensor_ops_tpu_torch.models import recurrent as R
from tensor_ops_tpu_torch.models.optim import adam, cosine_schedule
from tensor_ops_tpu_torch.models.trainer import fit_sequences
from torch_threads import one_torch_thread  # noqa: F401

TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()
JB = T.JaxBackend(dtype=jnp.float64)


def _mknet(be, seed=7):
    return R.gen_net(be, 4, 3, [(8, act_logistic(), act_logistic())],
                     act_logistic(), None, Rng(be, seed))


def _data(n=48, seq=5, seed=0):
    g = np.random.default_rng(seed)
    XS = g.standard_normal((n, seq, 4)).astype(np.float32)
    TS = g.standard_normal((n, seq, 3)).astype(np.float32)
    return XS, TS


def _leaves(res, ema=False):
    net = res.ema_net if ema else res.net
    return tuple(net.states) + tuple(net.params)


def _assert_bitwise(r1, r2, ema=False):
    for a, b in zip(_leaves(r1, ema), _leaves(r2, ema)):
        assert torch.equal(a, b), float((a - b).abs().max())


KW = dict(batch_size=8, rate_state=0.01, rate_param=0.05, verbose=False,
          seed=3)


@pytest.fixture
def graph_path(monkeypatch):
    """``StepChain``'s graph path on the CPU (see tests/test_torch_chain)."""
    def fake_capture(fn, device, what="the training step", **kw):
        fn(False)
        return type("Graph", (), {"replay": staticmethod(lambda: fn(True))})

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(engine, "capture", fake_capture)


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph"])
def test_chained_equals_unchained_dual_rate(graphs, request):
    if graphs:
        request.getfixturevalue("graph_path")
    XS, TS = _data()
    kw = dict(KW, epochs=4, log_every=3)
    r1 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps=1, **kw)
    r2 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps="auto", **kw)
    _assert_bitwise(r1, r2)
    assert [(h["step"], h["loss"]) for h in r1.history] == \
        [(h["step"], h["loss"]) for h in r2.history]


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph"])
def test_chained_equals_unchained_adam_ema_schedule(graphs, request):
    if graphs:
        request.getfixturevalue("graph_path")
    XS, TS = _data()
    kw = dict(KW, epochs=3, log_every=4, optimizer=adam(), ema_decay=0.9,
              lr_schedule=cosine_schedule(0.05, 18), clip_norm=1.0)
    r1 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps=1, **kw)
    r2 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps="auto", **kw)
    _assert_bitwise(r1, r2)
    _assert_bitwise(r1, r2, ema=True)


@pytest.mark.parametrize("opt", ["dual_rate", "adam"])
def test_chained_host_mode_matches_jax(opt):
    """The port's chained host-mode run and the JAX package's chained run
    of the same net on the same sequences: histories and final states,
    params and EMA at 1e-9."""
    XS, TS = _data()
    jn = j_gen_rnet(JB, 4, 3, [(8, j_logistic(), j_logistic())],
                    j_logistic(), None, JRng(JB, seed=5))
    tmpl = _mknet(TB)
    tn = R.RecurrentNetwork(tmpl.op,
                            tuple(TB.asarray(np.asarray(s))
                                  for s in jn.states),
                            tuple(TB.asarray(np.asarray(p))
                                  for p in jn.params), tmpl.arch)
    kw = dict(KW, epochs=3, log_every=4, ema_decay=0.8,
              lr_schedule=cosine_schedule(0.05, 18), chain_steps="auto")
    t = fit_sequences(tn, squared_error(3), TB, XS, TS,
                      optimizer=adam() if opt == "adam" else None, **kw)
    j = j_fit_seq(jn, j_sq(3), JB, XS, TS,
                  optimizer=JO.adam() if opt == "adam" else None, **kw)
    assert [h["step"] for h in t.history] == [h["step"] for h in j.history]
    for a, b in zip(t.history, j.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-9
    for ema in (False, True):
        jl = (j.ema_net if ema else j.net)
        for a, b in zip(_leaves(t, ema), tuple(jl.states) + tuple(jl.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-9)


def test_explicit_k_and_cap():
    XS, TS = _data()
    kw = dict(KW, epochs=3, log_every=6)
    r1 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps=1, **kw)
    r3 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps=3, **kw)
    _assert_bitwise(r1, r3)


def test_chain_validation():
    XS, TS = _data()
    with pytest.raises(ValueError, match="chain_steps"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                      chain_steps=0, **KW)
    with pytest.raises(ValueError, match="chain_steps"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                      chain_steps="always", **KW)
    with pytest.raises(ValueError, match="chain_shuffle"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                      chain_shuffle="nope", **KW)
    with pytest.raises(ValueError, match="whole batches"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS[:45], TS[:45],
                      chain_shuffle="device", **KW)
    with pytest.raises(ValueError, match="offload"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                      chain_steps=4, optimizer=adam(),
                      offload_opt_state=True, **KW)
    with pytest.raises(ValueError, match="offload_activations"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                      chain_steps=4, offload_activations=True, **KW)
    with pytest.raises(ValueError, match="fell back"):
        fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                      chain_shuffle="device", offload_activations=True,
                      **KW)


def test_auto_backs_off_with_offload_activations():
    XS, TS = _data()
    kw = dict(KW, epochs=2, log_every=3)
    r1 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       chain_steps=1, **kw)
    r2 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                       offload_activations=True, **kw)
    _assert_bitwise(r1, r2)


@pytest.mark.parametrize("mode", ["device", "device_fixed"])
def test_device_modes_partition_invariant(mode):
    """Other log cadences cut other windows and give the same state."""
    XS, TS = _data()
    r1 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS, epochs=3,
                       log_every=3, chain_shuffle=mode, **KW)
    r2 = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS, epochs=3,
                       log_every=5, chain_shuffle=mode, **KW)
    _assert_bitwise(r1, r2)
    host = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS, epochs=3,
                         log_every=3, **KW)
    assert not all(torch.equal(a, b)
                   for a, b in zip(_leaves(r1), _leaves(host)))


@pytest.mark.parametrize("mode", ["host", "device", "device_fixed"])
def test_chained_resume_bit_exact(mode, tmp_path):
    XS, TS = _data()
    ck = str(tmp_path / f"seqchain_{mode}.npz")
    kw = dict(KW, log_every=3, checkpoint_path=ck, checkpoint_every=6,
              chain_shuffle=mode)
    full = fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS,
                         epochs=3, **kw)
    fit_sequences(_mknet(TB), squared_error(3), TB, XS, TS, epochs=2, **kw)
    resumed = fit_sequences(_mknet(TB, seed=8), squared_error(3), TB, XS, TS,
                            epochs=3, resume=True, **kw)
    _assert_bitwise(full, resumed)


def test_val_and_early_stop_still_work_chained():
    XS, TS = _data(n=56)
    r = fit_sequences(_mknet(TB), squared_error(3), TB, XS[:48], TS[:48],
                      epochs=50, log_every=3, val=(XS[48:], TS[48:]),
                      early_stop_patience=2, chain_steps="auto", **KW)
    assert r.steps < 50 * 6  # stopped early
    assert all("val_loss" in h for h in r.history)


def test_chain_backs_off_on_numpy_backend():
    XS, TS = _data(n=16)
    r = fit_sequences(_mknet(TNB), squared_error(3), TNB, XS, TS, epochs=1,
                      chain_steps="auto", **KW)
    assert r.steps == 2
