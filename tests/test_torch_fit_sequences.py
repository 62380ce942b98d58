"""The port's ``fit_sequences`` against the JAX package's, on the CPU in f64.

A small Elman net (1 -> [4-8 logistic, logistic state] -> 1) is built once
by the JAX package and its states and parameters are copied into the
port's graph; both packages train it on the same numpy sequences with the
same shuffle seed.  Histories (steps, epochs, losses and validation losses
to 1e-9) and the final states, parameters and EMA (1e-9) must agree, the
tolerance of the JAX package's own trainer tests.  The crash/resume chains
are bit-exact within the port, and ``.state`` files pass between the
packages in both directions.  Each test ports the single-device, unchained
case of the JAX test it is named after (``tests/test_trainer.py``,
``test_production_knobs.py``, ``test_scan_offload.py``,
``test_donation.py``)."""

import os
import warnings

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
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork
from tensor_ops_tpu_torch.models.recurrent import gen_net as t_gen_rnet
from tensor_ops_tpu_torch.models.trainer import FitSeqResult
from tensor_ops_tpu_torch.models.trainer import fit_sequences as t_fit_seq
from tensor_ops_tpu_torch.models.training import seq_batch_loss
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
JNB = T.NumpyBackend()
TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()


def sine(n_seqs=64, T_=12, seed=0):
    """The JAX tests' phase-shifted sine sequences, (N, T, 1) each."""
    r = np.random.default_rng(seed)
    phases = r.uniform(0, 2 * np.pi, size=n_seqs)
    t = np.arange(T_ + 1) * 0.3
    waves = 0.5 + 0.5 * np.sin(phases[:, None] + t[None, :])
    return waves[:, :-1, None], waves[:, 1:, None]


def jrnet(be, h, seed):
    return j_gen_rnet(be, 1, 1, [(h, j_logistic(), j_logistic())],
                      j_logistic(), None, JRng(be, seed=seed))


def trnet(be, jn):
    """The port's graph of the same architecture holding ``jn``'s states
    and params (numpy copies) on ``be``."""
    h = int(np.asarray(jn.states[0]).shape[0])
    tmpl = t_gen_rnet(TB, 1, 1, [(h, t_logistic(), t_logistic())],
                      t_logistic(), None, TRng(TB, 0))
    return RecurrentNetwork(
        tmpl.op, tuple(be.asarray(np.asarray(s)) for s in jn.states),
        tuple(be.asarray(np.asarray(p)) for p in jn.params), tmpl.arch)


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def leaves(net):
    return tuple(net.states) + tuple(net.params)


def same_leaves(got, want, atol=ATOL):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(host(g), host(w), rtol=0, atol=atol)


def same_history(got, want, atol=ATOL):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["step"], g["epoch"]) == (w["step"], w["epoch"])
        assert set(g) == set(w)
        for key in ("loss", "val_loss"):
            if key in w:
                assert abs(g[key] - w[key]) <= atol, (key, g, w)


def both(jn, XS, TS, j_kw, t_kw=None, t_be=TB, j_be=JB, **common):
    """The JAX fit_sequences and the port's on one network and data."""
    t_kw = j_kw if t_kw is None else t_kw
    j = j_fit_seq(jn, j_sq(1), j_be, XS, TS, verbose=False, **common, **j_kw)
    t = t_fit_seq(trnet(t_be, jn), t_sq(1), t_be, XS, TS, verbose=False,
                  **common, **t_kw)
    return t, j


def test_fit_sequences_trains_and_resumes(tmp_path):
    """Dual-rate SGD: the port equals the JAX run at 1e-9, the loss falls,
    a crash/resume chain equals the straight run bit for bit, and the
    servable checkpoint loads in both packages."""
    XS, TS = sine()
    jn = jrnet(JB, 8, 3)
    kw = dict(batch_size=16, rate_state=0.01, rate_param=0.1, log_every=4)
    t, j = both(jn, XS, TS, {}, epochs=4, **kw)
    assert isinstance(t, FitSeqResult) and t.steps == j.steps == 16
    same_history(t.history, j.history)
    same_leaves(leaves(t.net), leaves(j.net))
    assert t.history[-1]["loss"] < t.history[0]["loss"]

    ck = str(tmp_path / "rnn.npz")
    t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=2,
              checkpoint_path=ck, checkpoint_every=4, verbose=False, **kw)
    resumed = t_fit_seq(trnet(TB, jrnet(JB, 8, 999)), t_sq(1), TB, XS, TS,
                        epochs=4, checkpoint_path=ck, checkpoint_every=4,
                        resume=True, verbose=False, **kw)
    assert resumed.steps == 16 and resumed.history[0]["step"] == 9
    for a, b in zip(leaves(resumed.net), leaves(t.net)):
        assert torch.equal(a, b)
    back = TC.load_recurrent(ck, trnet(TB, jn), TB)
    same_leaves(leaves(back), leaves(t.net), atol=0)
    jback = JC.load_recurrent(ck, jn, JB)
    same_leaves(leaves(jback), leaves(t.net), atol=0)


@pytest.mark.parametrize("be", [TB, TNB], ids=["torch", "numpy"])
def test_fit_sequences_resume_equivalence_property(tmp_path, be):
    """The crash/resume chain equals the uninterrupted run bit for bit on
    both of the port's backends, and the NumPy oracle's straight run equals
    the JAX package's NumPy oracle at 1e-9."""
    XS, TS = sine(n_seqs=24, T_=5, seed=2)
    jn = jrnet(JNB, 4, 4)
    ck = str(tmp_path / "r.npz")
    kw = dict(batch_size=8, rate_state=0.02, rate_param=0.1, verbose=False,
              log_every=50)
    t_fit_seq(trnet(be, jn), t_sq(1), be, XS, TS, epochs=1,
              checkpoint_path=ck, checkpoint_every=1, **kw)
    resumed = t_fit_seq(trnet(be, jrnet(JNB, 4, 88)), t_sq(1), be, XS, TS,
                        epochs=3, checkpoint_path=ck, checkpoint_every=1,
                        resume=True, **kw)
    straight = t_fit_seq(trnet(be, jn), t_sq(1), be, XS, TS, epochs=3, **kw)
    assert resumed.steps == straight.steps == 9
    for a, b in zip(leaves(resumed.net), leaves(straight.net)):
        np.testing.assert_array_equal(host(a), host(b))
    if be is TNB:
        assert all(isinstance(x, np.ndarray) for x in leaves(straight.net))
        j = j_fit_seq(jn, j_sq(1), JNB, XS, TS, epochs=3, **kw)
        same_history(straight.history, j.history)
        same_leaves(leaves(straight.net), leaves(j.net))


def test_fit_sequences_optimizer_clip_schedule(tmp_path):
    """adam + clip_norm + a cosine schedule: the port equals the JAX run at
    1e-9, the loss falls, and a crash/resume chain restores the moments
    bit for bit."""
    XS, TS = sine(n_seqs=32, T_=6, seed=7)
    jn = jrnet(JB, 6, 5)
    common = dict(batch_size=8, rate_state=0.02, rate_param=0.05,
                  clip_norm=1.0, log_every=2)
    t, j = both(jn, XS, TS,
                dict(optimizer=JO.adam(),
                     lr_schedule=JO.cosine_schedule(0.05, 12)),
                dict(optimizer=TO.adam(),
                     lr_schedule=TO.cosine_schedule(0.05, 12)),
                epochs=3, **common)
    assert t.steps == j.steps == 12
    same_history(t.history, j.history)
    same_leaves(leaves(t.net), leaves(j.net))
    assert t.history[-1]["loss"] < t.history[0]["loss"]

    kw = dict(common, optimizer=TO.adam(),
              lr_schedule=TO.cosine_schedule(0.05, 12), verbose=False)
    ck = str(tmp_path / "rnn_adam.npz")
    t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=1,
              checkpoint_path=ck, checkpoint_every=2, **kw)
    resumed = t_fit_seq(trnet(TB, jrnet(JB, 6, 99)), t_sq(1), TB, XS, TS,
                        epochs=3, checkpoint_path=ck, checkpoint_every=2,
                        resume=True, **kw)
    assert resumed.steps == 12
    for a, b in zip(leaves(resumed.net), leaves(t.net)):
        assert torch.equal(a, b)


def test_fit_sequences_optimizer_mismatch_rejected(tmp_path):
    XS, TS = sine(n_seqs=16, T_=4, seed=8)
    net = trnet(TB, jrnet(JB, 4, 6))
    ck = str(tmp_path / "rmm.npz")
    t_fit_seq(net, t_sq(1), TB, XS, TS, epochs=1, batch_size=8,
              optimizer=TO.adam(b1=0.9), checkpoint_path=ck,
              checkpoint_every=1, verbose=False)
    with pytest.raises(ValueError, match="optimizer mismatch"):
        t_fit_seq(net, t_sq(1), TB, XS, TS, epochs=2, batch_size=8,
                  optimizer=TO.adam(b1=0.5), checkpoint_path=ck,
                  checkpoint_every=1, resume=True, verbose=False)


@pytest.mark.parametrize("be", [TB, TNB], ids=["torch", "numpy"])
def test_fit_sequences_remat_matches_plain(be):
    """remat_every through the loop: the same trajectory as the plain
    scan (1e-12 as in the JAX test), and the JAX package's remat run at
    1e-9."""
    XS, TS = sine(n_seqs=16, T_=6, seed=9)
    jn = jrnet(JB, 4, 7)
    kw = dict(batch_size=8, rate_state=0.02, rate_param=0.1, verbose=False,
              log_every=1, epochs=2)
    a = t_fit_seq(trnet(be, jn), t_sq(1), be, XS, TS, **kw)
    b = t_fit_seq(trnet(be, jn), t_sq(1), be, XS, TS, remat_every=3, **kw)
    same_history(b.history, a.history, atol=1e-12)
    same_leaves(leaves(b.net), leaves(a.net), atol=1e-12)
    j = j_fit_seq(jn, j_sq(1), JB, XS, TS, remat_every=3, **kw)
    same_history(b.history, j.history)
    same_leaves(leaves(b.net), leaves(j.net))


def test_fit_sequences_warmup_schedule_stays_finite():
    """A warmup schedule at rp == 0 on step 0 stays finite under adam (the
    dual-rate ratio is passed, never computed as 0/0), and equals the JAX
    run at 1e-9."""
    XS, TS = sine(n_seqs=16, T_=5, seed=12)
    jn = jrnet(JB, 4, 13)
    warm = lambda s: 0.05 * min(1.0, s / 4.0)  # noqa: E731
    t, j = both(jn, XS, TS, dict(optimizer=JO.adam()),
                dict(optimizer=TO.adam()), epochs=3, batch_size=8,
                lr_schedule=warm, log_every=1)
    assert all(np.isfinite(h["loss"]) for h in t.history), t.history
    assert all(torch.isfinite(p).all() for p in leaves(t.net))
    same_history(t.history, j.history)
    same_leaves(leaves(t.net), leaves(j.net))


def test_fit_sequences_accum_matches_plain():
    """accum_steps=4 equals the plain full-batch step at 1e-9 (the mean
    of equal chunk means is the batch mean) and the JAX accumulated run
    at 1e-9; a batch that does not divide raises."""
    XS, TS = sine()
    jn = jrnet(JB, 8, 3)
    kw = dict(epochs=2, batch_size=16, rate_param=0.05, log_every=1)
    plain = t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS,
                      optimizer=TO.adam(), verbose=False, **kw)
    t, j = both(jn, XS, TS, dict(optimizer=JO.adam(), accum_steps=4),
                dict(optimizer=TO.adam(), accum_steps=4), **kw)
    assert len(t.history) == len(plain.history) > 3
    same_history(t.history, plain.history)
    same_leaves(leaves(t.net), leaves(plain.net))
    same_history(t.history, j.history)
    same_leaves(leaves(t.net), leaves(j.net))
    with pytest.raises(ValueError, match="divisible by"):
        t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, accum_steps=3,
                  batch_size=16, verbose=False)
    with pytest.raises(ValueError, match="requires the torch backend"):
        t_fit_seq(trnet(TNB, jn), t_sq(1), TNB, XS, TS, accum_steps=2,
                  batch_size=16, verbose=False)


def test_interrupt_saves_exact_resume_sequences(tmp_path):
    """Ctrl-C (KeyboardInterrupt) mid-run leaves an exact-resume
    checkpoint even with checkpoint_every=0: resumed and straight runs are
    bit-identical, and end within 1e-9 of the JAX straight run."""
    XS, TS = sine()
    jn = jrnet(JB, 6, 63)
    ck = str(tmp_path / "intrs.npz")
    kw = dict(batch_size=16, optimizer=TO.adam(), rate_param=0.05,
              rate_state=0.01, verbose=False, prefetch=0, log_every=1)

    def boom(step):
        if step == 3:
            raise KeyboardInterrupt
        return 0.05

    with pytest.raises(KeyboardInterrupt):
        t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=2,
                  lr_schedule=boom, checkpoint_path=ck, checkpoint_every=0,
                  **kw)
    assert os.path.exists(ck) and os.path.exists(ck + ".state")
    assert TC.load_meta(ck + ".state")["step"] == 3

    flat = lambda s: 0.05  # noqa: E731 — the interrupted run's lr
    resumed = t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=2,
                        lr_schedule=flat, checkpoint_path=ck,
                        checkpoint_every=0, resume=True, **kw)
    straight = t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=2,
                         lr_schedule=flat, **kw)
    assert resumed.steps == straight.steps == 8
    for a, b in zip(leaves(resumed.net), leaves(straight.net)):
        assert torch.equal(a, b)
    j = j_fit_seq(jn, j_sq(1), JB, XS, TS, epochs=2, lr_schedule=flat,
                  **dict(kw, optimizer=JO.adam()))
    same_leaves(leaves(straight.net), leaves(j.net))


def test_ema_sequences():
    """ema_decay averages states AND params: the EMA net equals the JAX
    one at 1e-9, trails the raw leaves, and runs."""
    t_ = np.linspace(0, 1, 10)
    r = np.random.default_rng(4)
    waves = np.sin(2 * np.pi * t_[None, :]
                   + r.uniform(0, np.pi, size=(32, 1)))
    XS, TS = waves[:, :-1, None], waves[:, 1:, None]
    jn = jrnet(JB, 6, 5)
    t, j = both(jn, XS, TS, dict(ema_decay=0.9), epochs=2, batch_size=16,
                rate_param=0.05, rate_state=0.01, prefetch=0, log_every=1)
    assert t.ema_net is not None
    same_history(t.history, j.history)
    same_leaves(leaves(t.net), leaves(j.net))
    same_leaves(leaves(t.ema_net), leaves(j.ema_net))
    assert any(not torch.allclose(a, b) for a, b in
               zip(t.ema_net.params, t.net.params))
    ys, _ = t.ema_net.run_seq(TB, TB.asarray(XS[0]))
    assert torch.isfinite(ys).all()


def test_fit_sequences_val_and_early_stop():
    """val=(XSv, TSv) logs the held-out sequence loss (the JAX values at
    1e-9), and early_stop_patience halts a run that cannot improve after
    1 + patience evaluations."""
    t_ = np.linspace(0, 1, 10)
    r = np.random.default_rng(14)
    waves = np.sin(2 * np.pi * t_[None, :]
                   + r.uniform(0, np.pi, size=(48, 1)))
    XS, TS = waves[:32, :-1, None], waves[:32, 1:, None]
    XSv, TSv = waves[32:, :-1, None], waves[32:, 1:, None]
    jn = jrnet(JB, 6, 15)
    t, j = both(jn, XS, TS, dict(val=(XSv, TSv)), epochs=2, batch_size=16,
                rate_param=0.05, rate_state=0.01, prefetch=0, log_every=1)
    assert all("val_loss" in h and np.isfinite(h["val_loss"])
               for h in t.history)
    same_history(t.history, j.history)

    stalled = t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=20,
                        batch_size=16, rate_param=0.0, rate_state=0.0,
                        val=(XSv, TSv), early_stop_patience=2,
                        verbose=False, prefetch=0, log_every=1)
    assert stalled.steps == 3, stalled.steps
    with pytest.raises(ValueError, match="early_stop_patience"):
        t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=1,
                  early_stop_patience=2, verbose=False, prefetch=0)
    # seq_batch_loss is the mean of the per-sequence seq_loss
    net = trnet(TB, jn)
    want = np.mean([float(net.seq_loss(t_sq(1), TB, TB.asarray(x),
                                       TB.asarray(y)))
                    for x, y in zip(XSv, TSv)])
    assert abs(seq_batch_loss(net, t_sq(1), TB, XSv, TSv) - want) < 1e-12


@pytest.mark.parametrize("kw", [
    dict(),
    dict(remat_every=2),
    dict(optimizer="adam"),
], ids=["sgd", "remat", "adam"])
def test_fit_sequences_offload_activations(kw):
    """offload_activations=True: the loss curve and the leaves are
    bit-equal to the run without it (on CPU tensors the tape stays where it
    is), and equal the JAX offloaded run at 1e-9."""
    r = np.random.default_rng(0)
    XS = r.normal(size=(16, 8, 2))
    TS = r.uniform(size=(16, 8, 2))
    jn = j_gen_rnet(JB, 2, 2, [(4, j_logistic(), j_logistic())],
                    j_logistic(), None, JRng(JB, seed=3))
    tmpl = t_gen_rnet(TB, 2, 2, [(4, t_logistic(), t_logistic())],
                      t_logistic(), None, TRng(TB, 0))

    def tnet():
        return RecurrentNetwork(
            tmpl.op, tuple(TB.asarray(np.asarray(s)) for s in jn.states),
            tuple(TB.asarray(np.asarray(p)) for p in jn.params), tmpl.arch)

    base = dict(epochs=2, batch_size=8, rate_param=0.05, rate_state=0.01,
                verbose=False, prefetch=0, log_every=1,
                remat_every=kw.get("remat_every"))
    opt = kw.get("optimizer")
    off = t_fit_seq(tnet(), t_sq(2), TB, XS, TS, offload_activations=True,
                    optimizer=opt and TO.adam(), **base)
    on = t_fit_seq(tnet(), t_sq(2), TB, XS, TS,
                   optimizer=opt and TO.adam(), **base)
    assert [h["loss"] for h in off.history] == [h["loss"] for h in on.history]
    for a, b in zip(leaves(off.net), leaves(on.net)):
        assert torch.equal(a, b)
    j = j_fit_seq(jn, j_sq(2), JB, XS, TS, offload_activations=True,
                  optimizer=opt and JO.adam(), **base)
    same_history(off.history, j.history)
    same_leaves(leaves(off.net), leaves(j.net))


def test_offload_activations_validation():
    """The NumPy oracle refuses offload_activations (its tape is on the
    host already), as the JAX package's does."""
    XS, TS = sine(n_seqs=8, T_=4)
    with pytest.raises(ValueError, match="offload_activations"):
        t_fit_seq(trnet(TNB, jrnet(JNB, 4, 0)), t_sq(1), TNB, XS, TS,
                  offload_activations=True, verbose=False)


def test_fit_sequences_preserves_callers_network():
    r = np.random.default_rng(7)
    t_ = np.linspace(0, 4 * np.pi, 33)
    XS = np.stack([np.sin(t_[:-1] + ph)[:, None]
                   for ph in r.uniform(0, np.pi, 24)])
    TS = np.stack([np.sin(t_[1:] + ph)[:, None]
                   for ph in r.uniform(0, np.pi, 24)])
    net = trnet(TB, jrnet(JB, 6, 8))
    before = tuple(x.clone() for x in leaves(net))
    res = t_fit_seq(net, t_sq(1), TB, XS, TS, epochs=1, batch_size=8,
                    optimizer=TO.adam(), rate_param=0.05, rate_state=0.01,
                    ema_decay=0.5, verbose=False, prefetch=0)
    for a, b in zip(leaves(net), before):
        assert torch.equal(a, b)
    assert not torch.equal(res.net.params[0], before[1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_files_pass_between_packages(tmp_path, writer):
    """A ``.state`` (adam moments, EMA, states + params) written by one
    package's fit_sequences after epoch 1 resumes in the other's, which
    ends within 1e-9 of the writer's straight 3-epoch run, EMA included."""
    XS, TS = sine(n_seqs=32, T_=6, seed=21)
    jn = jrnet(JB, 5, 22)
    ck = str(tmp_path / f"{writer}.npz")
    common = dict(batch_size=8, rate_state=0.02, rate_param=0.05,
                  ema_decay=0.8, log_every=1, verbose=False)
    jkw = dict(common, optimizer=JO.adam())
    tkw = dict(common, optimizer=TO.adam())
    if writer == "jax":
        j_fit_seq(jn, j_sq(1), JB, XS, TS, epochs=1, checkpoint_path=ck,
                  checkpoint_every=4, **jkw)
        straight = j_fit_seq(jn, j_sq(1), JB, XS, TS, epochs=3, **jkw)
        resumed = t_fit_seq(trnet(TB, jrnet(JB, 5, 9)), t_sq(1), TB, XS, TS,
                            epochs=3, checkpoint_path=ck, resume=True, **tkw)
    else:
        t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=1,
                  checkpoint_path=ck, checkpoint_every=4, **tkw)
        straight = t_fit_seq(trnet(TB, jn), t_sq(1), TB, XS, TS, epochs=3,
                             **tkw)
        resumed = j_fit_seq(jrnet(JB, 5, 9), j_sq(1), JB, XS, TS, epochs=3,
                            checkpoint_path=ck, resume=True, **jkw)
    assert resumed.steps == straight.steps == 12
    assert resumed.history[0]["step"] == 5
    same_history(resumed.history, straight.history[4:])
    same_leaves(leaves(resumed.net), leaves(straight.net))
    same_leaves(leaves(resumed.ema_net), leaves(straight.ema_net))


def test_resume_without_ema_warns_and_restarts(tmp_path):
    XS, TS = sine(n_seqs=16, T_=4, seed=3)
    net = trnet(TB, jrnet(JB, 4, 2))
    ck = str(tmp_path / "noe.npz")
    kw = dict(batch_size=8, verbose=False, checkpoint_path=ck,
              checkpoint_every=2)
    t_fit_seq(net, t_sq(1), TB, XS, TS, epochs=1, **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = t_fit_seq(net, t_sq(1), TB, XS, TS, epochs=2, resume=True,
                        ema_decay=0.9, **kw)
    assert any("carries no EMA" in str(x.message) for x in w)
    assert res.ema_net is not None and res.steps == 4


ACCEPTED = [dict(mixed_precision=True), dict(mixed_precision="bf16"),
            dict(chain_steps=4), dict(chain_shuffle="device")]


def _option_id(kw):
    return next(iter(kw)) + "=" + str(next(iter(kw.values())))


@pytest.mark.parametrize("kw", ACCEPTED, ids=[_option_id(k) for k in ACCEPTED])
def test_ported_options_train(kw):
    """The options ROADMAP items 5 and 6 ported (mixed precision, chained
    steps, the device shuffle) run and train."""
    XS, TS = sine(n_seqs=32, T_=6)
    res = t_fit_seq(trnet(TB, jrnet(JNB, 6, 0)), t_sq(1), TB, XS, TS,
                    epochs=6, batch_size=8, rate_state=0.05, rate_param=0.5,
                    log_every=4, verbose=False, **kw)
    assert res.steps == 24
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def _cpu_mesh(n, shape=None):
    from tensor_ops_tpu_torch.parallel import make_mesh

    return make_mesh(n, shape=shape, devices=["cpu"] * n)


def _StageMesh():
    """A pipeline mesh: a stage axis (``parallel.pipeline``)."""
    from tensor_ops_tpu_torch.parallel.pipeline import make_3d_pipeline_mesh

    return make_3d_pipeline_mesh(1, 2, 1, devices=["cpu"] * 2)


# what the mesh slice still refuses (naming its ROADMAP item) and the JAX
# package's own checks of the mesh, ZeRO and offload options
REFUSED = [
    # make_mesh(4) is (1, 4): a model axis, refused before the model axis
    # was ported; it trains now (item None)
    ("mesh=a mesh", dict(mesh=_cpu_mesh(4)), None),
    ("mesh=a stage axis", dict(mesh=_StageMesh()), "no pipeline mode"),
    ("shard_opt_state=True", dict(shard_opt_state=True),
     r"ZeRO-1 \(shard_opt_state/zero_stage\) shards over the mesh's data"),
    ("zero_stage=2", dict(zero_stage=2, mesh=_cpu_mesh(2, (2, 1))),
     "dual-rate SGD is stateless; pass optimizer=adam"),
    ("offload_opt_state=True", dict(offload_opt_state=True),
     "offload_opt_state needs optimizer state to offload"),
]


@pytest.mark.parametrize("kw,item", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_unported_options_raise(kw, item):
    """A stage axis raises (the scan has no pipeline mode); ZeRO without a
    mesh and ZeRO or offload without optimizer state raise the JAX
    package's messages.  A mesh with a model axis, once refused here,
    trains (``item`` None), its cell split over the model axis without a
    warning."""
    XS, TS = sine(n_seqs=8, T_=3)
    if item is None:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = t_fit_seq(trnet(TB, jrnet(JNB, 4, 0)), t_sq(1), TB, XS, TS,
                            verbose=False, batch_size=4, epochs=3,
                            log_every=1, **kw)
        assert not [x for x in w if "model" in str(x.message)]
        assert res.steps == 6 and all(hasattr(x, "spec") for x in
                                      res.net.states + res.net.params)
        assert all(np.isfinite(h["loss"]) for h in res.history)
        return
    with pytest.raises(ValueError, match=item):
        t_fit_seq(trnet(TB, jrnet(JNB, 4, 0)), t_sq(1), TB, XS, TS,
                  verbose=False, **kw)


def test_option_values_checked_as_jax_does():
    XS, TS = sine(n_seqs=8, T_=3)
    net = trnet(TB, jrnet(JNB, 4, 0))
    for kw, msg in ((dict(ema_decay=1.0), "ema_decay"),
                    (dict(chain_steps=0), "chain_steps"),
                    (dict(batch_size=9), "at least one batch")):
        with pytest.raises(ValueError, match=msg):
            t_fit_seq(net, t_sq(1), TB, XS, TS, verbose=False, **kw)
    # chain_steps=1 runs one step at a time, "auto" chains the windows
    for chain in (1, "auto"):
        res = t_fit_seq(net, t_sq(1), TB, XS, TS, batch_size=4,
                        chain_steps=chain, verbose=False)
        assert res.steps == 2


def test_train_batch_steps_on_the_shared_gradient():
    """``RecurrentNetwork.train_batch`` and fit_sequences' dual-rate step
    take the same mean gradient: one train_batch equals one fit_sequences
    step on the same batch, bit for bit."""
    XS, TS = sine(n_seqs=8, T_=5, seed=4)
    net = trnet(TB, jrnet(JB, 4, 1))
    res = t_fit_seq(net, t_sq(1), TB, XS, TS, batch_size=8, rate_state=0.02,
                    rate_param=0.1, verbose=False, prefetch=0)
    perm = np.random.default_rng(0).permutation(8)
    tb = net.train_batch(t_sq(1), 0.02, 0.1, TB, TB.asarray(XS[perm]),
                         TB.asarray(TS[perm]))
    for a, b in zip(leaves(res.net), leaves(tb)):
        assert torch.equal(a, b)
