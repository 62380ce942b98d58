"""The production knobs of the port's ``fit`` against the JAX package's, on
the CPU in f64: gradient accumulation (``accum_steps``), the Polyak average
(``ema_decay``) with its section of the ``.state`` format, and the Ctrl-C
checkpoint with its signal shield.

The networks are built once by the JAX package and copied into the port's
graph; both fits run on the same data and loader seed and must agree at
1e-9, the JAX trainer tests' tolerance.  Each test ports the single-device
case of the JAX test it is named after (``tests/test_trainer.py``,
``test_production_knobs.py``, ``test_donation.py``)."""

import os
import signal
import time
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
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.models.trainer import make_opt_step as j_make_opt_step
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.trainer import _sigint_shield
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.models.trainer import make_opt_step
from tensor_ops_tpu_torch.utils import checkpoint as TC
from tensor_ops_tpu_torch.utils.native import NativeLoader
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")


def task(n=256, seed=0):
    """The JAX knob tests' quadrant task on 2 inputs."""
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, 2))
    labels = (X[:, 0] * X[:, 1] > 0).astype(int)
    return X, np.eye(2)[labels], labels


def jnet(seed=0):
    return j_gen_net(JB, 2, 2, [(16, j_logistic())], j_softmax(),
                     JRng(JB, seed=seed))


def tnet(jn):
    tmpl = t_gen_net(TB, 2, 2, [(16, t_logistic())], t_softmax(),
                     TRng(TB, 0))
    return Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                  for p in jn.params), tmpl.act_names)


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def same_params(got, want, atol=ATOL):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(host(g), host(w), rtol=0, atol=atol)


def test_gradient_accumulation_matches_full_batch():
    """accum_steps=4 over a batch equals one full-batch step (the same
    mean gradient and update) at 1e-9, and the JAX accumulated step."""
    X, Y, _ = task(32, seed=9)
    jn = jnet(10)
    net = tnet(jn)
    xb, yb = TB.asarray(X), TB.asarray(Y)
    full = make_opt_step(net, t_xent(2), TB, TO.sgd())
    acc = make_opt_step(net, t_xent(2), TB, TO.sgd(), accum_steps=4)
    v1, _, p1 = full(0.3, xb, yb, (), net.params)
    v2, _, p2 = acc(0.3, xb, yb, (), net.params)
    assert abs(float(v1) - float(v2)) < ATOL
    same_params(p2, p1)
    jacc = j_make_opt_step(jn, j_xent(2), JB, JO.sgd(), accum_steps=4)
    jv, _, jp = jacc(0.3, JB.asarray(X), JB.asarray(Y), (), jn.params)
    assert abs(float(v2) - float(jv)) < ATOL
    same_params(p2, jp)


# (port optimizer, JAX optimizer, fit keyword arguments of both); 70 rows
# at batch 16: 5 steps an epoch, the last one ragged (6 rows)
CASES = {
    "sgd+accum2": (TO.sgd, JO.sgd, dict(lr=0.5, accum_steps=2)),
    "adam+accum4+ema": (TO.adam, JO.adam,
                        dict(lr=0.05, accum_steps=4, ema_decay=0.9)),
    "adamw+clip+ema+val": (lambda: TO.adamw(weight_decay=0.1),
                           lambda: JO.adamw(weight_decay=0.1),
                           dict(lr=0.05, clip_norm=0.5, ema_decay=0.8,
                                val=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_knobs_match_jax_fit(case):
    """The port's fit with accum_steps and ema_decay against the JAX fit:
    history, parameters and the EMA net at 1e-9."""
    t_opt, j_opt, kw = CASES[case]
    kw = dict(kw)
    X, Y, _ = task(70, 1)
    if kw.pop("val", False):
        Xv, _, Lv = task(30, 2)
        kw["val"] = (Xv, Lv)
    common = dict(epochs=3, batch_size=16, seed=3, log_every=1,
                  verbose=False, **kw)
    jn = jnet(4)
    j = j_fit(jn, j_xent(2), JB, X, Y, optimizer=j_opt(), **common)
    t = t_fit(tnet(jn), t_xent(2), TB, X, Y, optimizer=t_opt(), **common)
    assert t.steps == j.steps == 15
    assert len(t.history) == len(j.history) == 15
    for a, b in zip(t.history, j.history):
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
        assert abs(a["loss"] - b["loss"]) <= ATOL
        assert a.get("val_acc") == b.get("val_acc")
    same_params(t.net.params, j.net.params)
    if "ema_decay" in kw:
        same_params(t.ema_net.params, j.ema_net.params)
    else:
        assert t.ema_net is None and j.ema_net is None


def test_fit_accum_steps_divisibility_checked():
    X, Y, _ = task(32)
    with pytest.raises(ValueError, match="divisible by accum_steps"):
        t_fit(tnet(jnet()), t_xent(2), TB, X, Y, batch_size=10,
              accum_steps=3, verbose=False)
    with pytest.raises(ValueError, match="ema_decay"):
        t_fit(tnet(jnet()), t_xent(2), TB, X, Y, ema_decay=0.0,
              verbose=False)


def test_ema_matches_manual_recurrence():
    """FitResult.ema_net equals the EMA folded by hand over the per-step
    parameters of the same run, and the raw parameters equal the replayed
    run exactly."""
    X, Y, _ = task(n=64)
    d = 0.9
    kw = dict(epochs=2, batch_size=32, lr=0.05, optimizer=TO.adam(),
              verbose=False, prefetch=0, log_every=1)
    jn = jnet(2)
    res = t_fit(tnet(jn), t_xent(2), TB, X, Y, ema_decay=d, **kw)
    assert res.ema_net is not None

    net = tnet(jn)
    opt = TO.adam()
    step_fn = make_opt_step(net, t_xent(2), TB, opt)
    params = tuple(net.params)
    ema = params
    st = opt.init(params)
    loader = NativeLoader(X, Y, batch=32, seed=0)
    try:
        for _ in range(4):
            xb, yb = loader.next()
            _, st, params = step_fn(0.05, TB.asarray(xb), TB.asarray(yb),
                                    st, params)
            ema = tuple(d * e + (1 - d) * p for e, p in zip(ema, params))
    finally:
        loader.close()
    same_params(res.ema_net.params, ema)
    for a, b in zip(res.net.params, params):
        assert torch.equal(a, b)


def test_ema_resume_exact(tmp_path):
    """A crash/resume chain reproduces the uninterrupted EMA exactly; the
    EMA lives inside the .state file, which the JAX package's loader reads
    (4 EMA leaves: w0, b0, w1, b1)."""
    X, Y, _ = task(n=128)
    ck = str(tmp_path / "ema.npz")
    kw = dict(batch_size=32, lr=0.05, optimizer=TO.adam(), ema_decay=0.95,
              verbose=False, prefetch=0, log_every=1)
    jn = jnet(3)
    t_fit(tnet(jn), t_xent(2), TB, X, Y, epochs=1, checkpoint_path=ck,
          checkpoint_every=2, **kw)
    assert not os.path.exists(ck + ".ema")  # no sibling file to tear
    _, _, step, ema = JC.load_train_state(
        ck + ".state", JO.adam().init(tuple(jn.params)), with_ema=True)
    assert step == 4 and ema is not None and len(ema) == 4
    _, _, _, tema = TC.load_train_state(
        ck + ".state", TO.adam().init(tnet(jn).params), with_ema=True)
    same_params(tema, ema, atol=0)
    resumed = t_fit(tnet(jnet(9)), t_xent(2), TB, X, Y, epochs=2,
                    checkpoint_path=ck, checkpoint_every=2, resume=True,
                    **kw)
    straight = t_fit(tnet(jn), t_xent(2), TB, X, Y, epochs=2, **kw)
    for a, b in zip(resumed.ema_net.params, straight.ema_net.params):
        assert torch.equal(a, b)
    for a, b in zip(resumed.net.params, straight.net.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ema_state_resumes_across_packages(tmp_path, writer):
    """A ``.state`` with EMA leaves written by one package's fit resumes in
    the other's, which ends within 1e-9 of the writer's straight run, EMA
    included."""
    X, Y, _ = task(n=128)
    ck = str(tmp_path / f"{writer}.npz")
    common = dict(batch_size=32, lr=0.05, ema_decay=0.9, verbose=False,
                  log_every=1)
    jn = jnet(5)
    if writer == "jax":
        j_fit(jn, j_xent(2), JB, X, Y, epochs=1, optimizer=JO.adam(),
              checkpoint_path=ck, checkpoint_every=2, **common)
        straight = j_fit(jn, j_xent(2), JB, X, Y, epochs=2,
                         optimizer=JO.adam(), **common)
        resumed = t_fit(tnet(jnet(11)), t_xent(2), TB, X, Y, epochs=2,
                        optimizer=TO.adam(), checkpoint_path=ck,
                        resume=True, **common)
    else:
        t_fit(tnet(jn), t_xent(2), TB, X, Y, epochs=1, optimizer=TO.adam(),
              checkpoint_path=ck, checkpoint_every=2, **common)
        straight = t_fit(tnet(jn), t_xent(2), TB, X, Y, epochs=2,
                         optimizer=TO.adam(), **common)
        resumed = j_fit(jnet(11), j_xent(2), JB, X, Y, epochs=2,
                        optimizer=JO.adam(), checkpoint_path=ck,
                        resume=True, **common)
    assert resumed.steps == straight.steps == 8
    same_params(resumed.net.params, straight.net.params)
    same_params(resumed.ema_net.params, straight.ema_net.params)


def test_ema_resume_from_non_ema_checkpoint_warns(tmp_path):
    """Resuming a checkpoint saved without ema_decay under a run with it
    restarts the average from the restored parameters, with a warning."""
    X, Y, _ = task(n=128)
    ck = str(tmp_path / "noe.npz")
    kw = dict(batch_size=32, lr=0.05, optimizer=TO.adam(), verbose=False,
              prefetch=0, log_every=1)
    jn = jnet(8)
    t_fit(tnet(jn), t_xent(2), TB, X, Y, epochs=1, checkpoint_path=ck,
          checkpoint_every=2, **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = t_fit(tnet(jn), t_xent(2), TB, X, Y, epochs=2,
                    checkpoint_path=ck, checkpoint_every=2, resume=True,
                    ema_decay=0.95, **kw)
    assert any("carries no EMA" in str(x.message) for x in w)
    assert res.ema_net is not None


def test_interrupt_saves_exact_resume_checkpoint(tmp_path):
    """Ctrl-C (KeyboardInterrupt) mid-run leaves an exact-resume
    checkpoint even with no periodic checkpointing: resume + straight run
    are bit-identical, and equal the JAX straight run at 1e-9."""
    r = np.random.default_rng(61)
    X = r.uniform(0, 1, size=(64, 8))
    Y = np.eye(4)[r.integers(0, 4, size=64)]
    ck = str(tmp_path / "intr.npz")
    jn = j_gen_net(JB, 8, 4, [(8, j_logistic())], j_softmax(),
                   JRng(JB, seed=62))
    tmpl = t_gen_net(TB, 8, 4, [(8, t_logistic())], t_softmax(),
                     TRng(TB, 0))

    def net():
        return Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                      for p in jn.params), tmpl.act_names)

    kw = dict(batch_size=16, optimizer=TO.adam(), verbose=False,
              prefetch=0, log_every=1)

    def boom(step):
        if step == 5:
            raise KeyboardInterrupt
        return 0.05

    with pytest.raises(KeyboardInterrupt):
        t_fit(net(), t_xent(4), TB, X, Y, epochs=2, lr_schedule=boom,
              checkpoint_path=ck, checkpoint_every=0, **kw)
    assert os.path.exists(ck) and os.path.exists(ck + ".state")
    assert TC.load_meta(ck + ".state")["step"] == 5

    flat = lambda s: 0.05  # noqa: E731 — the interrupted run's lr
    resumed = t_fit(net(), t_xent(4), TB, X, Y, epochs=2, lr_schedule=flat,
                    checkpoint_path=ck, checkpoint_every=0, resume=True, **kw)
    straight = t_fit(net(), t_xent(4), TB, X, Y, epochs=2, lr_schedule=flat,
                     **kw)
    assert resumed.steps == straight.steps == 8
    for a, b in zip(resumed.net.params, straight.net.params):
        assert torch.equal(a, b)
    j = j_fit(jn, j_xent(4), JB, X, Y, epochs=2, lr_schedule=flat,
              **dict(kw, optimizer=JO.adam()))
    same_params(straight.net.params, j.net.params)


def _sgd_named(name, on_update=None):
    """sgd under another name; ``on_update(call)`` runs inside each update,
    that is inside the loop's step."""
    calls = [0]

    def update(state, params, grads, lr):
        calls[0] += 1
        if on_update is not None:
            on_update(calls[0])
        return (), tuple(p - lr * g for p, g in zip(params, grads))

    return TO.Optimizer(lambda params: (), update, name, hyper=())


def test_sigint_inside_a_step_checkpoints_that_step(tmp_path):
    """A real SIGINT delivered inside step 3 is deferred to the step's end:
    the Ctrl-C checkpoint holds step 3 (with its EMA), and resuming it
    ends bit-equal to the straight run."""
    X, Y, _ = task(n=64)
    ck = str(tmp_path / "sig.npz")
    jn = jnet(12)
    kw = dict(epochs=2, batch_size=16, lr=0.1, ema_decay=0.5, verbose=False,
              prefetch=0, log_every=1)

    def kill(call):
        if call == 3:
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)  # let the interpreter run the handler

    with pytest.raises(KeyboardInterrupt):
        t_fit(tnet(jn), t_xent(2), TB, X, Y, checkpoint_path=ck,
              optimizer=_sgd_named("sgd_sig", kill), **kw)
    assert TC.load_meta(ck + ".state")["step"] == 3
    resumed = t_fit(tnet(jnet(13)), t_xent(2), TB, X, Y, checkpoint_path=ck,
                    resume=True, optimizer=_sgd_named("sgd_sig"), **kw)
    straight = t_fit(tnet(jn), t_xent(2), TB, X, Y,
                     optimizer=_sgd_named("sgd_sig"), **kw)
    assert resumed.steps == straight.steps == 8
    assert resumed.history[0]["step"] == 4
    for a, b in zip(resumed.net.params + resumed.ema_net.params,
                    straight.net.params + straight.ema_net.params):
        assert torch.equal(a, b)


def test_sigint_shield_defers_to_exit():
    prev = signal.getsignal(signal.SIGINT)
    saw_pending = []
    with pytest.raises(KeyboardInterrupt):
        with _sigint_shield() as sh:
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)  # let the interpreter run the handler
            saw_pending.append(sh.pending)
    assert saw_pending == [True], "SIGINT must be deferred, not raised"
    assert signal.getsignal(signal.SIGINT) is prev


def test_sigint_shield_double_press_escapes():
    prev = signal.getsignal(signal.SIGINT)
    reached_end = False
    with pytest.raises(KeyboardInterrupt):
        with _sigint_shield():
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)
            reached_end = True
    assert not reached_end, "second press must raise immediately"
    assert signal.getsignal(signal.SIGINT) is prev


def test_sigint_shield_chains_onto_a_failing_step():
    """A step that raises while a Ctrl-C is pending surfaces the interrupt
    chained onto the step's own exception."""
    with pytest.raises(KeyboardInterrupt) as info:
        with _sigint_shield():
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)
            raise RuntimeError("the step failed")
    assert isinstance(info.value.__cause__, RuntimeError)


def test_sigint_shield_is_a_no_op_off_the_main_thread():
    import threading

    out = {}

    def body():
        with _sigint_shield() as sh:
            out["armed"] = sh._armed

    th = threading.Thread(target=body)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and out == {"armed": False}
