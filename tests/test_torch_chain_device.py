"""The device index streams of ``fit(chain_shuffle="device" |
"device_fixed")``, the port of the JAX package's
``tests/test_chain_device.py``.  The port draws its epoch permutations
from a ``torch.Generator`` seeded from (seed, epoch), not from threefry,
so the streams are held by their properties, as there: each epoch visits
every row once, the indices are a pure function of (seed, absolute step)
(every window partition and every crash/resume chain replays the same
batches), another seed gives another stream; and ``fit`` checks the
knob as the JAX package does."""

import numpy as np
import pytest
import torch

from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (act_logistic, act_softmax,
                                         cross_entropy, gen_net)
from tensor_ops_tpu_torch import engine
from tensor_ops_tpu_torch.models import chain as C
from tensor_ops_tpu_torch.models.optim import adam, cosine_schedule, sgd
from tensor_ops_tpu_torch.models.trainer import (_device_fixed_perm,
                                                 _device_window_indices,
                                                 _device_window_offsets, fit)
from torch_threads import one_torch_thread  # noqa: F401

TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()


def _mknet(be, seed=1):
    return gen_net(be, 16, 4, [(32, act_logistic())], act_softmax(),
                   Rng(be, seed))


def _data(n=512, seed=0):
    g = np.random.default_rng(seed)
    X = g.uniform(-1, 1, (n, 16)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[g.integers(0, 4, n)]
    return X, Y


def _equal(ps, qs):
    return all(torch.equal(a, b) for a, b in zip(ps, qs))


# ---------------------------------------------------------------------------
# the index streams themselves
# ---------------------------------------------------------------------------

def test_device_indices_cover_each_epoch_exactly_once():
    n, batch = 96, 16
    spe = n // batch
    idx = _device_window_indices(3, n, batch, spe, 0, 3 * spe).numpy()
    assert idx.shape == (3 * spe, batch)
    for e in range(3):
        assert np.array_equal(np.sort(idx[e * spe:(e + 1) * spe].ravel()),
                              np.arange(n))
    assert not np.array_equal(idx[:spe], idx[spe:2 * spe])


def test_device_indices_are_window_partition_invariant():
    n, batch, spe = 64, 16, 4
    whole = _device_window_indices(7, n, batch, spe, 0, 11)
    parts = [_device_window_indices(7, n, batch, spe, s0, k)
             for s0, k in [(0, 3), (3, 5), (8, 3)]]
    assert torch.equal(whole, torch.cat(parts))
    # a window starting mid-epoch (step 5 = epoch 1, slot 1)
    assert torch.equal(whole[5:9],
                       _device_window_indices(7, n, batch, spe, 5, 4))


def test_device_indices_seed_sensitivity():
    a = _device_window_indices(0, 64, 16, 4, 0, 4)
    b = _device_window_indices(1, 64, 16, 4, 0, 4)
    assert not torch.equal(a, b)
    assert not torch.equal(_device_window_offsets(0, 16, 8, 0, 8),
                           _device_window_offsets(1, 16, 8, 0, 8))


def test_device_fixed_offsets_cover_each_epoch_exactly_once():
    """Each epoch visits every batch SLOT once (a fresh order per epoch);
    with the fixed row permutation every epoch still covers every row
    once."""
    spe, batch = 6, 16
    offs = _device_window_offsets(3, batch, spe, 0, 3 * spe)
    assert offs.shape == (3 * spe,)
    for e in range(3):
        slots = np.sort(offs[e * spe:(e + 1) * spe].numpy()) // batch
        assert np.array_equal(slots, np.arange(spe))
    assert not torch.equal(offs[:spe], offs[spe:2 * spe])
    parts = [_device_window_offsets(3, batch, spe, s0, k)
             for s0, k in [(0, 5), (5, 9), (14, 4)]]
    assert torch.equal(offs, torch.cat(parts))
    p = _device_fixed_perm(3, 96)
    assert np.array_equal(np.sort(p.numpy()), np.arange(96))
    assert torch.equal(p, _device_fixed_perm(3, 96))
    assert not torch.equal(p, _device_fixed_perm(4, 96))


# ---------------------------------------------------------------------------
# fit(chain_shuffle="device" | "device_fixed")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["device", "device_fixed"])
def test_device_mode_partition_invariance_full_surface(mode):
    """The trajectory depends only on (seed, step): other window caps and
    log cadences cut the run into other windows and give the same params,
    EMA and (where steps coincide) logged losses, bit for bit."""
    X, Y = _data(512)
    kw = dict(epochs=3, batch_size=64, optimizer=adam(),
              lr_schedule=cosine_schedule(0.01, 24), ema_decay=0.9,
              chain_shuffle=mode, verbose=False, seed=3)
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps="auto",
             log_every=7, **kw)
    r2 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_steps=5,
             log_every=3, **kw)
    assert r1.steps == r2.steps == 24
    assert _equal(r1.net.params, r2.net.params)
    assert _equal(r1.ema_net.params, r2.ema_net.params)
    l1 = {r["step"]: r["loss"] for r in r1.history}
    l2 = {r["step"]: r["loss"] for r in r2.history}
    for s in set(l1) & set(l2):
        assert l1[s] == l2[s]


@pytest.mark.parametrize("mode", ["device", "device_fixed"])
def test_device_mode_resume_bit_exact(mode, tmp_path):
    X, Y = _data(512)
    ck = str(tmp_path / "dev.npz")
    kw = dict(batch_size=64, optimizer=sgd(), lr=0.05, log_every=4,
              chain_shuffle=mode, verbose=False, seed=9)
    r_full = fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=4, **kw)
    fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=2,
        checkpoint_path=ck, checkpoint_every=8, **kw)
    r_res = fit(_mknet(TB, seed=99), cross_entropy(4), TB, X, Y, epochs=4,
                checkpoint_path=ck, checkpoint_every=8, resume=True, **kw)
    assert r_res.steps == r_full.steps == 32
    assert _equal(r_full.net.params, r_res.net.params)


def test_device_mode_trains_and_history_complete():
    X, Y = _data(512)
    r = fit(_mknet(TB), cross_entropy(4), TB, X, Y, epochs=6,
            batch_size=64, lr=0.5, log_every=8, chain_shuffle="device",
            verbose=False)
    assert [h["step"] for h in r.history] == [1] + list(range(8, 49, 8))
    assert r.history[-1]["loss"] < r.history[0]["loss"]


def test_device_modes_differ_and_device_fixed_trains():
    X, Y = _data(512)
    kw = dict(epochs=3, batch_size=64, optimizer=adam(), log_every=7,
              verbose=False, seed=3)
    fx = fit(_mknet(TB), cross_entropy(4), TB, X, Y,
             chain_shuffle="device_fixed", **kw)
    dv = fit(_mknet(TB), cross_entropy(4), TB, X, Y, chain_shuffle="device",
             **kw)
    host = fit(_mknet(TB), cross_entropy(4), TB, X, Y, **kw)
    assert not _equal(fx.net.params, dv.net.params)
    assert not _equal(dv.net.params, host.net.params)
    assert fx.history[-1]["loss"] < fx.history[0]["loss"]


def test_device_mode_graph_path_uploads_no_indices(monkeypatch):
    """Through the graph path the device modes fill the row table on the
    device from the start step; the windows' rows are the stream's."""
    seen = []

    def fake_capture(fn, device, what="the training step", **kw):
        fn(False)
        return type("Graph", (), {"replay": staticmethod(lambda: fn(True))})

    real_run = C.StepChain.run

    def run(self, scalars, rows, leaves):
        seen.append(rows)
        return real_run(self, scalars, rows, leaves)

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(engine, "capture", fake_capture)
    monkeypatch.setattr(C.StepChain, "run", run)
    X, Y = _data(512)
    kw = dict(epochs=2, batch_size=64, lr=0.1, log_every=4, verbose=False,
              seed=5, chain_shuffle="device")
    r1 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, **kw)
    assert all(isinstance(r, torch.Tensor) for r in seen)
    rows = torch.cat(seen).numpy()
    assert np.array_equal(rows, _device_window_indices(5, 512, 64, 8, 0,
                                                       16).numpy())
    monkeypatch.setattr(engine, "uses_graphs", lambda device: False)
    r2 = fit(_mknet(TB), cross_entropy(4), TB, X, Y, **kw)
    assert _equal(r1.net.params, r2.net.params)


def test_device_mode_validation():
    X, Y = _data(130)  # ragged against batch 64
    with pytest.raises(ValueError, match="ragged tail"):
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, batch_size=64,
            chain_shuffle="device", verbose=False)
    X, Y = _data(128)
    with pytest.raises(ValueError, match="chain_shuffle"):
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, batch_size=64,
            chain_shuffle="both", verbose=False)
    with pytest.raises(ValueError, match="fell back"):
        fit(_mknet(TB), cross_entropy(4), TB, X, Y, batch_size=64,
            chain_steps=1, chain_shuffle="device", verbose=False)
    with pytest.raises(ValueError, match="fell back"):
        fit(_mknet(TNB), cross_entropy(4), TNB, X, Y, batch_size=64,
            chain_shuffle="device", verbose=False)
