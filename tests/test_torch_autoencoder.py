"""The port's autoencoder (``models/autoencoder.py``, ``FusedAutoencoder``)
against the JAX package's, on the CPU.

``Encoder`` on ``TorchBackend(f64, cpu)`` and on the port's NumPy oracle
against the JAX ``Encoder`` on its f64 backend and its oracle, parameters
copied across: ``test_loss``, ``grad``, ``train`` and ``fit`` to 1e-9.
``FusedAutoencoder`` on CPU tensors runs the train-step kernel's plain
version; the JAX one runs the Pallas kernel in interpret mode at
``precision="highest"``; both in f32, held as ``tests/test_autoencoder.py``
holds the kernel to the IR step (loss to 1e-5, parameters to 1e-5 +
1e-5 |ref|).  The autoencoder checkpoint passes between the packages."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import squared_error as j_se
from tensor_ops_tpu.models.autoencoder import Encoder as JEncoder
from tensor_ops_tpu.models.fast import FusedAutoencoder as JFAE
from tensor_ops_tpu.models.feedforward import Network as JNetwork
from tensor_ops_tpu.models.optim import adam as j_adam
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Encoder, FusedAutoencoder, Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import squared_error as t_se
from tensor_ops_tpu_torch.models.optim import adam as t_adam
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
I, H, Z = 8, 5, 3
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
BACKENDS = {"torch": (TB, JB), "numpy": (NumpyBackend(), T.NumpyBackend())}


def j_encoder(seed=5):
    rng = JRng(JB, seed=seed)
    return JEncoder(
        j_gen_net(JB, I, Z, [(H, j_logistic())], j_logistic(), rng),
        j_gen_net(JB, Z, I, [(H, j_logistic())], j_logistic(), rng))


def copy_encoder(jenc, t_be, j_be):
    """The JAX encoder's parameters in the port's graphs on ``t_be`` and,
    as arrays of ``j_be``, in the JAX graphs."""
    def port(jnet, i, o):
        tmpl = t_gen_net(TB, i, o, [(H, t_logistic())], t_logistic(),
                         TRng(TB, 0))
        return Network(tmpl.op, tuple(t_be.asarray(np.asarray(p))
                                      for p in jnet.params), tmpl.act_names)

    def jax(jnet):
        return JNetwork(jnet.op, tuple(j_be.asarray(np.asarray(p))
                                       for p in jnet.params), jnet.act_names)

    return (Encoder(port(jenc.encoder, I, Z), port(jenc.decoder, Z, I)),
            JEncoder(jax(jenc.encoder), jax(jenc.decoder)))


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(gots, wants, atol=ATOL):
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(host(g), host(w), rtol=0, atol=atol)


def samples(n, seed=1):
    return np.random.default_rng(seed).uniform(0.05, 0.95, size=(n, I))


@pytest.mark.parametrize("kind", list(BACKENDS))
def test_encoder_matches_jax(kind):
    t_be, j_be = BACKENDS[kind]
    tenc, jenc = copy_encoder(j_encoder(), t_be, j_be)
    x = samples(1)[0]
    tx, jx = t_be.asarray(x), j_be.asarray(x)
    close([tenc.encode(t_be, tx)], [jenc.encode(j_be, jx)])
    close([tenc.encode_decode(t_be, tx)], [jenc.encode_decode(j_be, jx)])
    assert abs(tenc.test_loss(t_se(I), t_be, tx)
               - jenc.test_loss(j_se(I), j_be, jx)) <= ATOL
    (tgE, tgD), (jgE, jgD) = (tenc.grad(t_se(I), t_be, tx),
                              jenc.grad(j_se(I), j_be, jx))
    close(tgE + tgD, jgE + jgD)
    for x in samples(4, seed=2):
        tenc = tenc.train(t_se(I), 0.5, t_be, t_be.asarray(x))
        jenc = jenc.train(j_se(I), 0.5, j_be, j_be.asarray(x))
    close(tenc.encoder.params + tenc.decoder.params,
          jenc.encoder.params + jenc.decoder.params)
    assert tenc.encoder.act_names == jenc.encoder.act_names


def test_encoder_fit_matches_jax():
    tenc, jenc = copy_encoder(j_encoder(seed=7), TB, JB)
    X = samples(40, seed=3)
    kw = dict(epochs=2, batch_size=16, lr=0.02, log_every=1, verbose=False,
              seed=4)
    t2, tres = tenc.fit(t_se(I), TB, X, optimizer=t_adam(), **kw)
    j2, jres = jenc.fit(j_se(I), JB, X, optimizer=j_adam(), **kw)
    assert tres.steps == jres.steps == 6
    for g, w in zip(tres.history, jres.history):
        assert (g["step"], g["epoch"]) == (w["step"], w["epoch"])
        assert abs(g["loss"] - w["loss"]) <= ATOL
    assert tres.history[-1]["loss"] < tres.history[0]["loss"]
    close(t2.encoder.params + t2.decoder.params,
          j2.encoder.params + j2.decoder.params)
    assert len(t2.encoder.params) == 4 and t2.decoder.act_names == \
        ("logistic", "logistic")


def fused_pair():
    jenc = j_encoder(seed=9)
    tenc, _ = copy_encoder(jenc, TorchBackend(torch.float32, "cpu"), JB)
    return (FusedAutoencoder.from_encoder(tenc, precision="highest"),
            JFAE.from_encoder(jenc, precision="highest"), tenc, jenc)


def test_fused_autoencoder_matches_jax_kernel():
    """Three whole steps at B=5 through 8-5-3-5-8 (four layers, as the
    card's 784-128-32-128-784): the port's plain step against the JAX
    kernel in interpret mode."""
    tf, jf, _, _ = fused_pair()
    assert (tf.n_enc, tf.mlp.loss_kind, tf.mlp.softmax_out) == \
        (jf.n_enc, jf.mlp.loss_kind, jf.mlp.softmax_out) == (2, "mse", False)
    assert tf.mlp.acts == jf.mlp.acts
    X = samples(5, seed=6).astype(np.float32)
    for _ in range(3):
        tl, tf = tf.train(0.5, torch.tensor(X))
        jl, jf = jf.train(0.5, jnp.asarray(X))
        assert abs(tl - jl) <= 1e-5
        for a, b in zip(tf.mlp.to_params(), jf.mlp.to_params()):
            np.testing.assert_allclose(host(a), np.asarray(b, np.float64),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(host(tf.encode_decode(torch.tensor(X))),
                               np.asarray(jf.encode_decode(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-5)


def test_fused_autoencoder_round_trips_to_the_encoder():
    """One fused step at B=1 is the IR ``Encoder.train`` step, and
    ``to_encoder`` writes it back into the staged graphs."""
    tf, _, tenc, _ = fused_pair()
    x = samples(1, seed=8).astype(np.float32)
    loss, tf2 = tf.train(0.5, torch.tensor(x))
    be = TorchBackend(torch.float32, "cpu")
    assert abs(loss - tenc.test_loss(t_se(I), be, be.asarray(x[0]))) <= 1e-5
    want = tenc.train(t_se(I), 0.5, be, be.asarray(x[0]))
    back = tf2.to_encoder(tenc)
    for a, b in zip(back.encoder.params + back.decoder.params,
                    want.encoder.params + want.decoder.params):
        np.testing.assert_allclose(host(a), host(b), rtol=1e-5, atol=1e-5)


def test_autoencoder_checkpoints_pass_between_packages(tmp_path):
    tf, jf, _, _ = fused_pair()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save_autoencoder(jpath, jf)
    TC.save_autoencoder(tpath, tf)
    back = TC.load_autoencoder(jpath, device="cpu")
    assert back.n_enc == jf.n_enc and back.mlp.acts == jf.mlp.acts
    assert back.mlp.loss_kind == "mse" and not back.mlp.softmax_out
    for a, b in zip(back.mlp.to_params(), jf.mlp.to_params()):
        np.testing.assert_array_equal(host(a), np.asarray(b))
    jback = JC.load_autoencoder(tpath)
    assert jback.n_enc == tf.n_enc and jback.mlp.acts == tf.mlp.acts
    assert jback.mlp.precision == "highest"
    for a, b in zip(jback.mlp.to_params(), tf.mlp.to_params()):
        np.testing.assert_array_equal(np.asarray(a), host(b))
    assert TC.load_meta(tpath)["kind"] == "fused_autoencoder"


def test_autoencoder_example_runs(tmp_path, monkeypatch):
    from tensor_ops_tpu_torch.examples import autoencoder_digits
    from tensor_ops_tpu_torch.utils import mnist_data

    def offline(url, timeout=20.0):
        raise OSError("offline")

    monkeypatch.setattr(mnist_data, "_fetch", offline)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        autoencoder_digits.main(["--device", "cpu", "-d", str(tmp_path)])
    out = buf.getvalue()
    assert "initial reconstruction loss" in out
    assert out.count("reconstruction loss") == 4
