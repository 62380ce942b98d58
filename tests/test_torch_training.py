"""The port's learn layer against the JAX package's, on the CPU in f64.

A network is built once by the JAX package (``gen_net`` with its threefry
RNG); its parameters are copied into the port's ``Network`` as numpy
arrays, and both packages get the same seeded numpy inputs.  The
staged-IR gradient entry points (``Network.net_grad`` ... ``induce_many``)
and the batched trainers of ``models/training.py`` must agree to 1e-9, as
the JAX package's own backend and trainer tests hold (``test_backends.py``,
``test_trainer.py``); classes (argmax) must agree exactly."""

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
from tensor_ops_tpu.models import training as JT
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import training as TT

ATOL = 1e-9
SMALL = (12, (8,), 4)
FLAGSHIP = (784, (300, 100), 10)
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")


def nets(shape, seed=0):
    """The same network in both packages: built by the JAX package, its
    parameters copied into the port's graph."""
    i, hidden, o = shape
    jnet = j_gen_net(JB, i, o, [(h, j_logistic()) for h in hidden],
                     j_softmax(), JRng(JB, seed=seed))
    tmpl = t_gen_net(TB, i, o, [(h, t_logistic()) for h in hidden],
                     t_softmax(), TRng(TB, 0))
    tnet = Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                  for p in jnet.params), tmpl.act_names)
    return jnet, tnet, j_xent(o), t_xent(o)


def data(shape, n, seed=1):
    i, _, o = shape
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, size=(n, i))
    labels = r.integers(0, o, size=n)
    return x, np.eye(o)[labels], labels


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def all_close(gots, wants, atol=ATOL):
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        close(g, w, atol)


NETWORK_FNS = ["net_grad", "network_gradient", "loss_value", "train",
               "induce", "induce_many"]


@pytest.mark.parametrize("fn", NETWORK_FNS)
@pytest.mark.parametrize("shape", [SMALL, FLAGSHIP],
                         ids=["12-8-4", "flagship"])
def test_network_learning_entry_points_match_jax(shape, fn):
    jnet, tnet, jl, tl = nets(shape)
    x, y, _ = data(shape, 1)
    jx, jy, tx, ty = JB.asarray(x[0]), JB.asarray(y[0]), \
        TB.asarray(x[0]), TB.asarray(y[0])
    if fn in ("net_grad", "network_gradient"):
        all_close(getattr(tnet, fn)(tl, TB, tx, ty),
                  getattr(jnet, fn)(jl, JB, jx, jy))
    elif fn == "loss_value":
        close(tnet.loss_value(tl, TB, tx, ty),
              jnet.loss_value(jl, JB, jx, jy))
    elif fn == "train":
        t2, j2 = tnet.train(tl, 0.5, TB, tx, ty), jnet.train(jl, 0.5, JB,
                                                              jx, jy)
        all_close(t2.params, j2.params)
        assert t2.op is tnet.op and t2.act_names == tnet.act_names
    elif fn == "induce":
        close(tnet.induce(tl, 0.5, TB, ty, tx), jnet.induce(jl, 0.5, JB,
                                                             jy, jx))
    else:
        close(tnet.induce_many(tl, 1.0, TB, ty, tx, 5),
              jnet.induce_many(jl, 1.0, JB, jy, jx, 5))


def test_train_fold_matches_jax_and_per_sample_train():
    jnet, tnet, jl, tl = nets(SMALL, seed=2)
    x, y, _ = data(SMALL, 20, seed=3)
    got = TT.train_fold(tnet, tl, TB, 0.3, TB.asarray(x), TB.asarray(y))
    all_close(got.params, JT.train_fold(jnet, jl, JB, 0.3, JB.asarray(x),
                                        JB.asarray(y)).params)
    step = tnet
    for xi, yi in zip(x, y):
        step = step.train(tl, 0.3, TB, TB.asarray(xi), TB.asarray(yi))
    all_close(got.params, [p.numpy() for p in step.params], 0.0)


@pytest.mark.parametrize("shape", [SMALL, FLAGSHIP],
                         ids=["12-8-4", "flagship"])
def test_train_minibatch_matches_jax(shape):
    jnet, tnet, jl, tl = nets(shape, seed=4)
    x, y, _ = data(shape, 10, seed=5)
    for _ in range(2):
        tv, tnet = TT.train_minibatch(tnet, tl, TB, 0.4, TB.asarray(x),
                                      TB.asarray(y))
        jv, jnet = JT.train_minibatch(jnet, jl, JB, 0.4, JB.asarray(x),
                                      JB.asarray(y))
        close(tv, jv)
        all_close(tnet.params, jnet.params)


def test_minibatch_gradient_is_mean_of_per_sample_gradients():
    _, tnet, _, tl = nets(SMALL, seed=6)
    x, y, _ = data(SMALL, 7, seed=7)
    vals, grads = TT.make_vmapped_grads(tnet, tl, TB)(
        TB.asarray(x), TB.asarray(y), *tnet.params)
    assert vals.shape == (7,)
    for k in range(7):
        g = tnet.network_gradient(tl, TB, TB.asarray(x[k]), TB.asarray(y[k]))
        all_close([gg[k] for gg in grads], [p.numpy() for p in g], 1e-12)
    _, stepped = TT.train_minibatch(tnet, tl, TB, 1.0, TB.asarray(x),
                                    TB.asarray(y))
    all_close(stepped.params, [(p - g.mean(dim=0)).numpy()
                               for p, g in zip(tnet.params, grads)], 1e-12)


def test_batch_loss_accuracy_and_confusion_match_jax():
    jnet, tnet, jl, tl = nets(SMALL, seed=8)
    x, y, labels = data(SMALL, 40, seed=9)
    close(TT.batch_loss(tnet, tl, TB, x, y),
          JT.batch_loss(jnet, jl, JB, x, y))
    jout = np.asarray(JT.batched_run(jnet, JB)(JB.asarray(x), *jnet.params))
    tout = TT.batched_run(tnet, TB)(TB.asarray(x), *tnet.params)
    close(tout, jout)
    np.testing.assert_array_equal(tout.argmax(dim=1).numpy(),
                                  jout.argmax(axis=1))
    assert TT.accuracy(tnet, TB, TB.asarray(x), labels) == \
        JT.accuracy(jnet, JB, JB.asarray(x), labels)
    tconf = TT.confusion(tnet, TB, TB.asarray(x), labels, 4)
    np.testing.assert_array_equal(
        tconf, JT.confusion(jnet, JB, JB.asarray(x), labels, 4))
    assert tconf.sum() == 40 and tconf.dtype == np.int64


def test_batched_run_agrees_with_per_sample_run():
    _, tnet, _, _ = nets(SMALL, seed=10)
    x, _, _ = data(SMALL, 6, seed=11)
    out = TT.batched_run(tnet, TB)(TB.asarray(x), *tnet.params)
    for k in range(6):
        close(out[k], tnet.run(TB, TB.asarray(x[k])).numpy(), 1e-12)
    assert TT.batched_run(tnet, TB) is TT.batched_run(tnet, TB)  # cached
