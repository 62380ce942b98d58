"""The engine's compiled entry points (``engine.py``: ``Compiled``, ``Loop``),
the port's ``jax.jit``, on the CPU.

On the card every entry point the JAX package jits runs from one CUDA graph
per input shape (``engine.maybe_jit`` / ``engine.jit``), the per-sample fold
and the induction loop from one captured step replayed once a step
(``engine.Loop``).  The CPU cannot capture, so the ``graph_path`` fixture
stands in as ``tests/test_torch_chain.py`` and
``tests/test_torch_serve_graphs.py`` do: ``engine.uses_graphs`` says yes for
CPU tensors and ``engine.capture`` warms the function up and returns a graph
whose replay runs the captured call on the graph's static buffers.  The
engine's bookkeeping (static buffers, traced rates, outputs copied out,
signatures, the LRU, the loop's step counter and carry, the rules that run
direct) then runs on the CPU.

Every entry point is held bit for bit to its direct call (``engine.direct``)
at its first call (the capture's warm-up) and at a replay, and to the JAX
package's counterpart on the same numpy inputs: 1e-9 in f64 for the staged
IR (the JAX package's own bound, ``tests/test_backends.py``), the
``tests/test_pallas.py``, ``tests/test_torch_rnn_step.py`` and
``tests/test_torch_autoencoder.py`` tolerances (1e-5 absolute and relative
in f32) where a kernel's plain version runs, ``tests/test_torch_int8_serve.py``'s
for the int8 forwards (1e-6 for w8, one code step of the last layer for
w8a8); exactly for classes and counts.  The calls that run direct
(``DIRECT``: those of one kernel launch, ``FusedMLP.run`` and
``QuantizedMLP.run``) capture nothing through the graph path and give the
direct call's bits; ``run_xla``'s graph reads the weights in place."""

import contextlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu.models as JM
import tensor_ops_tpu.models.fast as JF
import tensor_ops_tpu.models.recurrent as JR
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import training as JT
from tensor_ops_tpu.models.autoencoder import Encoder as JEncoder
from tensor_ops_tpu.utils import checkpoint as JC
import tensor_ops_tpu_torch.models as TM
import tensor_ops_tpu_torch.models.recurrent as TR
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend, engine
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import (Encoder, FusedAutoencoder, FusedMLP,
                                         FusedRNN, Network)
from tensor_ops_tpu_torch.models import training as TT
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.parallel import mesh as PM
from tensor_ops_tpu_torch.utils import checkpoint as TC
from tensor_ops_tpu_torch.utils import profiling as TP
from torch_threads import one_torch_thread  # noqa: F401

TOL64 = (1e-9, 0.0)   # (atol, rtol)
TOL32 = (1e-5, 1e-5)
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
I, H, O = 12, 8, 4


@pytest.fixture
def graph_path(monkeypatch):
    """Run every compiled call through the engine's graph path on the CPU:
    ``capture`` warms the function up and returns a graph whose replay runs
    the captured call.  Returns the list of what each capture named."""
    captured = []

    def fake_capture(fn, device, what="", remedy="", streams=None,
                     pool=None):
        fn(False)
        captured.append(what)
        return type("Graph", (), {"replay": staticmethod(lambda: fn(True))})

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(engine, "capture", fake_capture)
    engine.reset_graph_counts()
    return captured


def host(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        # bf16 widens to float32 exactly
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def leaves(out) -> list:
    """The leaves of an entry point's result: tensors, numbers, arrays and
    the parameters of the models in it."""
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in leaves(o)]
    if isinstance(out, Network):
        return list(out.params)
    if isinstance(out, TR.RecurrentNetwork):
        return list(out.states) + list(out.params)
    if isinstance(out, Encoder):
        return leaves(out.encoder) + leaves(out.decoder)
    if isinstance(out, FusedMLP):
        return list(out.to_params())
    if isinstance(out, FusedAutoencoder):
        return leaves(out.mlp)
    if isinstance(out, FusedRNN):
        return [out.wX, out.wS, out.b, out.s0]
    if isinstance(out, JM.feedforward.Network):
        return list(out.params)
    if isinstance(out, JR.RecurrentNetwork):
        return list(out.states) + list(out.params)
    if isinstance(out, JEncoder):
        return leaves(out.encoder) + leaves(out.decoder)
    if isinstance(out, JF.FusedMLP):
        return list(out.to_params())
    if isinstance(out, JF.FusedAutoencoder):
        return leaves(out.mlp)
    if isinstance(out, JF.FusedRNN):
        return [out.wX, out.wS, out.b, out.s0]
    return [out]


def bit_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(host(x), host(y)) and type(x) is type(y)
        for x, y in zip(la, lb))


def close(got, want, tol):
    lg, lw = leaves(got), leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        np.testing.assert_allclose(np.asarray(host(g), np.float64),
                                   np.asarray(host(w), np.float64),
                                   atol=tol[0], rtol=tol[1])


# ---------------------------------------------------------------------------
# one model of each family in both packages
# ---------------------------------------------------------------------------

def ff_pair(seed=0):
    """A 12-8-4 network built by the JAX package, its parameters copied
    into the port's graph."""
    jnet = JM.gen_net(JB, I, O, [(H, JM.act_logistic())], JM.act_softmax(),
                      JRng(JB, seed=seed))
    tmpl = TM.gen_net(TB, I, O, [(H, TM.act_logistic())], TM.act_softmax(),
                      TRng(TB, 0))
    tnet = Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                  for p in jnet.params), tmpl.act_names)
    return jnet, tnet, JM.cross_entropy(O), TM.cross_entropy(O)


def ff_data(n, seed=1):
    r = np.random.default_rng(seed)
    labels = r.integers(0, O, size=n)
    return r.uniform(0, 1, size=(n, I)), np.eye(O)[labels], labels


def rnn_build(M, R, be, rng):
    lg = M.act_logistic
    return R.gen_net(be, 4, 2, [(5, lg(), lg()), (3, lg(), None)], lg(),
                     None, rng)


def rnn_pair(seed=11):
    """A two-layer recurrent net built by the JAX package, its states and
    params in the port's net of the same construction."""
    jnet = rnn_build(JM, JR, JB, JRng(JB, seed=seed))
    tmpl = rnn_build(TM, TR, TB, TRng(TB, seed=0))
    arrays, meta = JC._recurrent_payload(jnet, None)
    tnet = TC.recurrent_from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, tmpl, TB)
    return jnet, tnet, JM.squared_error(2), TM.squared_error(2)


def seqs(B, n, seed=2):
    r = np.random.default_rng(seed)
    return r.uniform(-1, 1, size=(B, n, 4)), r.uniform(0, 1, size=(B, n, 2))


def enc_pair(seed=5):
    rng = JRng(JB, seed=seed)
    je = JEncoder(JM.gen_net(JB, 8, 3, [(5, JM.act_logistic())],
                             JM.act_logistic(), rng),
                  JM.gen_net(JB, 3, 8, [(5, JM.act_logistic())],
                             JM.act_logistic(), rng))

    def port(jnet, i, o):
        tmpl = TM.gen_net(TB, i, o, [(5, TM.act_logistic())],
                          TM.act_logistic(), TRng(TB, 0))
        return Network(tmpl.op, tuple(TB.asarray(np.asarray(p))
                                      for p in jnet.params), tmpl.act_names)

    return je, Encoder(port(je.encoder, 8, 3), port(je.decoder, 3, 8))


def f32(a):
    return np.asarray(a, dtype=np.float32)


def mlp_pair(seed=3, dims=(12, 8, 6, 4)):
    r = np.random.default_rng(seed)
    ws = [f32(r.normal(size=(dims[k + 1], dims[k])) / np.sqrt(dims[k]))
          for k in range(len(dims) - 1)]
    bs = [f32(r.normal(size=dims[k + 1]) * 0.3)
          for k in range(len(dims) - 1)]
    acts = ("logistic", "tanh", "identity")
    jm = JF.FusedMLP(tuple(jnp.asarray(w) for w in ws),
                     tuple(jnp.asarray(b) for b in bs), acts,
                     precision="highest")
    tm = FusedMLP.from_numpy(ws, bs, acts, device="cpu")
    x = f32(r.uniform(0, 1, size=(16, dims[0])))
    y = f32(np.eye(dims[-1])[r.integers(0, dims[-1], size=16)])
    return jm, tm, x, y


def fae_pair():
    je, te = enc_pair(seed=7)
    jf = JF.FusedAutoencoder.from_encoder(je)
    tf = FusedAutoencoder.from_encoder(te)
    jf = JF.FusedAutoencoder(JF.FusedMLP(
        tuple(jnp.asarray(f32(w)) for w in jf.mlp.weights),
        tuple(jnp.asarray(f32(b)) for b in jf.mlp.biases), jf.mlp.acts,
        False, "highest", "mse"), jf.n_enc)
    tf = FusedAutoencoder(tf.mlp.astype(torch.float32), tf.n_enc)
    X = f32(np.random.default_rng(6).uniform(0.05, 0.95, size=(5, 8)))
    return jf, tf, X


def rnn_fused(impl, seed=3, i=5, o=7):
    r = np.random.default_rng(seed)
    wX, wS = f32(r.normal(size=(o, i)) * 0.3), f32(r.normal(size=(o, o)) * 0.3)
    b, s0 = f32(r.normal(size=o) * 0.1), f32(r.normal(size=o) * 0.5)
    jm = JF.FusedRNN(*(jnp.asarray(a) for a in (wX, wS, b, s0)),
                     precision="highest", impl=impl)
    tm = FusedRNN.from_numpy(wX, wS, b, s0, precision="highest", impl=impl,
                             device="cpu")
    xs = f32(r.normal(size=(11, i)))
    tg = f32(0.3 * r.normal(size=(11, o)))
    return jm, tm, xs, tg


# ---------------------------------------------------------------------------
# every entry point: (the port's call, the JAX package's result, tolerance)
# ---------------------------------------------------------------------------

def _ff(fn):
    def case():
        jnet, tnet, jl, tl = ff_pair()
        x, y, labels = ff_data(9)
        return fn(jnet, tnet, jl, tl, x, y, labels)
    return case


def _tj(a):
    return TB.asarray(a), JB.asarray(a)


def _ff_one(name):
    def fn(jnet, tnet, jl, tl, x, y, labels):
        tx, jx = _tj(x[0])
        ty, jy = _tj(y[0])
        if name == "run":
            return (lambda: tnet.run(TB, tx)), jnet.run(JB, jx), TOL64
        if name in ("net_grad", "network_gradient", "loss_value"):
            return ((lambda: getattr(tnet, name)(tl, TB, tx, ty)),
                    getattr(jnet, name)(jl, JB, jx, jy), TOL64)
        if name == "induce":
            return ((lambda: tnet.induce(tl, 0.5, TB, ty, tx)),
                    jnet.induce(jl, 0.5, JB, jy, jx), TOL64)
        if name == "train":
            return ((lambda: tnet.train(tl, 0.5, TB, tx, ty)),
                    jnet.train(jl, 0.5, JB, jx, jy), TOL64)
        return ((lambda: tnet.induce_many(tl, 1.0, TB, ty, tx, 5)),
                jnet.induce_many(jl, 1.0, JB, jy, jx, 5), TOL64)
    return _ff(fn)


def _ff_batch(name):
    def fn(jnet, tnet, jl, tl, x, y, labels):
        tX, jX = _tj(x)
        tY, jY = _tj(y)
        if name == "train_fold":
            return ((lambda: TT.train_fold(tnet, tl, TB, 0.3, tX, tY)),
                    JT.train_fold(jnet, jl, JB, 0.3, jX, jY), TOL64)
        if name == "batched_run":
            return ((lambda: TT.batched_run(tnet, TB)(tX, *tnet.params)),
                    JT.batched_run(jnet, JB)(jX, *jnet.params), TOL64)
        if name == "train_minibatch":
            return ((lambda: TT.train_minibatch(tnet, tl, TB, 0.3, tX, tY)),
                    JT.train_minibatch(jnet, jl, JB, 0.3, jX, jY), TOL64)
        if name == "batch_loss":
            return ((lambda: TT.batch_loss(tnet, tl, TB, x, y)),
                    JT.batch_loss(jnet, jl, JB, x, y), TOL64)
        if name == "accuracy":
            return ((lambda: TT.accuracy(tnet, TB, x, labels)),
                    JT.accuracy(jnet, JB, jX, labels), (0.0, 0.0))
        return ((lambda: TT.confusion(tnet, TB, x, labels, O)),
                JT.confusion(jnet, JB, jX, labels, O), (0.0, 0.0))
    return _ff(fn)


def _rnn(name):
    def case():
        jnet, tnet, jl, tl = rnn_pair()
        xs, tg = seqs(3, 6)
        if name in ("train_batch", "seq_losses", "seq_batch_loss"):
            tX, jX = _tj(xs)
            tT, jT = _tj(tg)
            if name == "train_batch":
                return ((lambda: tnet.train_batch(tl, 0.1, 0.2, TB, tX, tT)),
                        jnet.train_batch(jl, 0.1, 0.2, JB, jX, jT), TOL64)
            if name == "seq_losses":
                # the JAX package has no per-sequence form: its mean
                return ((lambda: TT.seq_losses(tnet, tl, TB, xs, tg)
                         .mean().reshape(1)),
                        np.asarray([JT.seq_batch_loss(jnet, jl, JB, xs, tg)]),
                        TOL64)
            return ((lambda: TT.seq_batch_loss(tnet, tl, TB, xs, tg)),
                    JT.seq_batch_loss(jnet, jl, JB, xs, tg), TOL64)
        tx, jx = _tj(xs[0])
        tt, jt = _tj(tg[0])
        if name == "run":
            return ((lambda: tnet.run(TB, tx[0])), jnet.run(JB, jx[0]),
                    TOL64)
        if name == "run_seq":
            return (lambda: tnet.run_seq(TB, tx)), jnet.run_seq(JB, jx), TOL64
        if name in ("seq_grad", "seq_loss"):
            return ((lambda: getattr(tnet, name)(tl, TB, tx, tt)),
                    getattr(jnet, name)(jl, JB, jx, jt), TOL64)
        return ((lambda: tnet.train(tl, 0.1, 0.2, TB, tx, tt)),
                jnet.train(jl, 0.1, 0.2, JB, jx, jt), TOL64)
    return case


def _enc(name):
    def case():
        je, te = enc_pair()
        x = np.random.default_rng(1).uniform(0.05, 0.95, size=8)
        tx, jx = _tj(x)
        tl, jl = TM.squared_error(8), JM.squared_error(8)
        if name == "test_loss":
            return ((lambda: te.test_loss(tl, TB, tx)),
                    je.test_loss(jl, JB, jx), TOL64)
        if name == "grad":
            return (lambda: te.grad(tl, TB, tx)), je.grad(jl, JB, jx), TOL64
        return ((lambda: te.train(tl, 0.5, TB, tx)),
                je.train(jl, 0.5, JB, jx), TOL64)
    return case


def quantized_pair(mode, seed=3):
    """``mlp_pair``'s network quantized by the JAX package, its codes in the
    port's ``QuantizedMLP``, and the one-code-step w8a8 tolerance."""
    jm, _, x, _ = mlp_pair(seed)
    jq = JF.QuantizedMLP.from_fused(jm, mode=mode)
    tq = TM.QuantizedMLP.from_numpy(
        [np.asarray(q) for q in jq.wqs], [np.asarray(s) for s in jq.scales],
        [np.asarray(b) for b in jq.biases], jq.acts, jq.softmax_out, mode,
        device="cpu")
    tol = 1e-6 if mode == "w8" else float(np.asarray(jq.scales[-1]).max())
    return jq, tq, x, (tol, 0.0)


def uniform_quantized(seed=40, N=128, L=3, B=5):
    """A uniform 128-wide int8 stack (relu, softmax out) in both packages,
    ``tests/test_torch_int8.py``'s ``uniform_stack``."""
    from tensor_ops_tpu.ops import pallas_kernels as PK
    from tensor_ops_tpu.testing import rand as r

    ws = [jnp.asarray(r(seed + k, N, N) * 0.2, jnp.float32) for k in range(L)]
    bs = [jnp.asarray(r(seed + 10 + k, N) * 0.1, jnp.float32)
          for k in range(L)]
    qs, ss = zip(*(PK.quantize_weights_int8(w) for w in ws))
    acts = ("relu",) * (L - 1) + ("identity",)
    jq = JF.QuantizedMLP(tuple(qs), tuple(ss), tuple(bs), acts)
    tq = TM.QuantizedMLP.from_numpy(
        [np.asarray(q) for q in qs], [np.asarray(s) for s in ss],
        [np.asarray(b) for b in bs], acts, device="cpu")
    return jq, tq, f32(r(seed + 20, B, N))


def _forward(name):
    """The forwards: ``FusedMLP.run`` / ``run_xla`` /
    ``run_fused_inference``, ``QuantizedMLP.run`` in both modes and
    ``run_fused``."""
    def case():
        if name.startswith("QuantizedMLP-"):
            jq, tq, x, tol = quantized_pair(name.split("-")[1])
            return (lambda: tq.run(torch.tensor(x))), jq.run(
                jnp.asarray(x)), tol
        if name == "QuantizedMLP.run_fused":
            jq, tq, x = uniform_quantized()
            return ((lambda: tq.run_fused(torch.tensor(x))),
                    jq.run_fused(jnp.asarray(x)), TOL32)
        jm, tm, x, _ = mlp_pair()
        method = name.split(".")[1]
        return ((lambda: getattr(tm, method)(torch.tensor(x))),
                getattr(jm, method)(jnp.asarray(x)), TOL32)
    return case


def _fused(name):
    def case():
        if name.startswith("FusedRNN"):
            impl = name.split("-")[1]
            jm, tm, xs, tg = rnn_fused(impl)
            if "seq_forward" in name:
                return (lambda: tm.seq_forward(xs)), jm.seq_forward(xs), \
                    TOL32
            return ((lambda: tm.train(0.01, 0.001, xs, tg)),
                    jm.train(0.01, 0.001, xs, tg), TOL32)
        if name == "FusedAutoencoder.train":
            jf, tf, X = fae_pair()
            return ((lambda: tf.train(0.5, torch.tensor(X))),
                    jf.train(0.5, jnp.asarray(X)), TOL32)
        jm, tm, x, y = mlp_pair()
        tx, ty = torch.tensor(x), torch.tensor(y)
        if name == "FusedMLP.train":
            return ((lambda: tm.train(0.2, tx, ty)),
                    jm.train(0.2, jnp.asarray(x), jnp.asarray(y)), TOL32)
        return ((lambda: tm.train_fullfused(0.2, tx, ty)),
                jm.train_fullfused(0.2, jnp.asarray(x), jnp.asarray(y)),
                TOL32)
    return case


CASES = {
    **{f"Network.{n}": _ff_one(n)
       for n in ("run", "net_grad", "network_gradient", "loss_value",
                 "induce", "train", "induce_many")},
    **{n: _ff_batch(n) for n in ("train_fold", "batched_run",
                                 "train_minibatch", "batch_loss",
                                 "accuracy", "confusion")},
    **{f"RecurrentNetwork.{n}": _rnn(n)
       for n in ("run", "run_seq", "seq_grad", "seq_loss", "train",
                 "train_batch")},
    "seq_losses": _rnn("seq_losses"),
    "seq_batch_loss": _rnn("seq_batch_loss"),
    **{f"Encoder.{n}": _enc(n) for n in ("test_loss", "grad", "train")},
    **{n: _fused(n) for n in (
        "FusedMLP.train", "FusedMLP.train_fullfused",
        "FusedAutoencoder.train", "FusedRNN-xla-seq_forward",
        "FusedRNN-pallas-seq_forward", "FusedRNN-xla-train",
        "FusedRNN-pallas-train")},
    **{n: _forward(n) for n in (
        "FusedMLP.run", "FusedMLP.run_xla", "FusedMLP.run_fused_inference",
        "QuantizedMLP-w8-run", "QuantizedMLP-w8a8-run",
        "QuantizedMLP.run_fused")},
}
# the calls that run direct, never from a graph: those of one kernel
# launch, and the forwards a graph made no faster on the card
DIRECT = {"FusedMLP.train_fullfused", "FusedAutoencoder.train",
          "FusedMLP.run_fused_inference", "QuantizedMLP.run_fused",
          "FusedMLP.run", "QuantizedMLP-w8-run", "QuantizedMLP-w8a8-run"}


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_graph_path_is_its_direct_call_and_matches_jax(
        name, graph_path):
    """The first call (the capture's warm-up) and a replay are bit-equal
    to the direct call; the JAX package's result is within the
    tolerance; at least one capture, and the replay captures nothing.  A
    call that runs direct (``DIRECT``) captures nothing and replays
    nothing: every call is its direct call."""
    port, want, tol = CASES[name]()
    with engine.direct():
        direct = port()
    first = port()
    caps = engine.graph_counts()["captures"]
    again = port()
    if name in DIRECT:
        assert engine.graph_counts() | {"capture_s": 0} == {
            "captures": 0, "capture_s": 0, "replays": 0} and not graph_path
    else:
        assert caps >= 1 and graph_path
        assert engine.graph_counts()["captures"] == caps
        assert engine.graph_counts()["replays"] >= 1
    assert bit_equal(first, direct), name
    assert bit_equal(again, direct), name
    close(again, want, tol)


# ---------------------------------------------------------------------------
# the mechanism
# ---------------------------------------------------------------------------

def test_run_under_autograd_runs_direct_and_differentiates(graph_path):
    """``FusedMLP.run`` recorded by autograd (weights that require grad)
    runs direct, captures nothing, and its gradient is the direct call's
    and the JAX package's ``jax.grad`` of its forward (1e-5)."""
    import jax

    jm, tm, x, _ = mlp_pair()
    ws = [w.clone().requires_grad_() for w in tm.weights]
    bs = [b.clone().requires_grad_() for b in tm.biases]
    m = FusedMLP(ws, bs, tm.acts, tm.softmax_out, tm.precision)
    cot = f32(np.random.default_rng(8).normal(size=(16, 4)))
    got = torch.autograd.grad((m.run(torch.tensor(x)) * torch.tensor(cot))
                              .sum(), ws + bs)
    assert engine.graph_counts()["captures"] == 0 and not graph_path
    with engine.direct():
        want = torch.autograd.grad(
            (m.run(torch.tensor(x)) * torch.tensor(cot)).sum(), ws + bs)
    assert bit_equal(list(got), list(want))

    def jloss(ws, bs):
        return (JF.FusedMLP(ws, bs, jm.acts, precision="highest")
                .run(jnp.asarray(x)) * cot).sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jm.weights, jm.biases)
    close(list(got), list(jg[0]) + list(jg[1]), TOL32)


def test_a_forward_keys_its_graph_on_the_weights_dtype(graph_path):
    """``astype`` shares the model's ``_cache``: its bf16 weights take a
    graph of their own beside the f32 one, each call bit-equal to its
    direct call, a second call of either replaying."""
    _, tm, x, _ = mlp_pair()
    x = torch.tensor(x)
    bf = tm.astype(torch.bfloat16)
    for model in (tm, bf, tm, bf):
        with engine.direct():
            want = model.run_xla(x)
        assert bit_equal(model.run_xla(x), want), model.weights[0].dtype
    assert bf._cache is tm._cache and len(tm._cache["fwd_xla"].graphs) == 2
    assert engine.graph_counts()["captures"] == 2
    assert engine.graph_counts()["replays"] == 2


# the compiled forwards: (model maker, method, cache key)
IN_PLACE = {
    "FusedMLP.run_xla": (lambda: mlp_pair()[1:3], "run_xla", "fwd_xla"),
}


@pytest.mark.parametrize("name", list(IN_PLACE))
def test_a_forward_reads_its_weights_in_place(graph_path, name):
    """A compiled forward's graph reads the model's weights where they lie:
    its static buffers are its input and output rows alone, it keeps no
    reference to a weight, a weight changed in place is read by the next
    replay (no capture), and a model whose weights lie elsewhere (a
    trainer's next model, sharing the cache) captures a graph of its own;
    every call bit-equal to its direct call."""
    make, method, key = IN_PLACE[name]
    model, x = make()
    x = torch.tensor(x)
    call = getattr(model, method)
    out = call(x)
    fn = model._cache[key]
    (g,) = fn.graphs.values()
    assert fn.static_bytes() == x.nbytes + out.nbytes
    assert not [b for b in g.statics.bufs if isinstance(b, torch.Tensor)
                and b.numel() > x.numel()]
    w = model.biases[0]
    w.add_(0.25)
    with engine.direct():
        want = call(x)
    assert bit_equal(call(x), want)
    assert engine.graph_counts()["captures"] == 1
    if isinstance(model, FusedMLP):
        other = model._replaced([v.clone() for v in model.weights],
                                [v.clone() for v in model.biases])
        with engine.direct():
            want = getattr(other, method)(x)
        assert bit_equal(getattr(other, method)(x), want)
        assert other._cache is model._cache and len(fn.graphs) == 2
        assert engine.graph_counts()["captures"] == 2


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_forward_pads_its_codes_once(graph_path, monkeypatch,
                                               mode):
    """``QuantizedMLP.run`` (direct) takes the codes padded once per model
    (``_cache["padded"]``), never per call; ``run_fused`` takes the stack
    made once at construction; neither captures."""
    import tensor_ops_tpu_torch.models.fast as TF

    pads = []
    real = TF.pad_codes
    monkeypatch.setattr(TF, "pad_codes", lambda q: pads.append(1) or real(q))
    _, tq, x, _ = quantized_pair(mode)
    x = torch.tensor(x)
    outs = [tq.run(x) for _ in range(3)]
    padded = tq._cache["padded"]
    outs.append(tq.run(x))
    assert len(pads) == len(tq.wqs) and tq._cache["padded"] is padded
    assert all(torch.equal(o, outs[0]) for o in outs)
    _, uq, ux = uniform_quantized()
    stacked = uq._cache["stacked"]
    uq.run_fused(torch.tensor(ux))
    assert uq._cache["stacked"] is stacked
    assert engine.graph_counts()["captures"] == 0 and not graph_path


def test_a_second_rate_reuses_the_graph(graph_path):
    """A rate is traced: new rates replay the graph of the first and give
    each rate's direct result (the per-sample step and the fold); kernel
    3's step launches direct, its rate by value, and captures nothing."""
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(6)
    tx, ty = TB.asarray(x), TB.asarray(y)
    _, tm, mx, my = mlp_pair()
    mx, my = torch.tensor(mx), torch.tensor(my)
    calls = {
        "train": lambda r: tnet.train(tl, r, TB, tx[0], ty[0]),
        "fold": lambda r: TT.train_fold(tnet, tl, TB, r, tx, ty),
        "fullfused": lambda r: tm.train_fullfused(r, mx, my),
    }
    for what, call in calls.items():
        engine.reset_graph_counts()
        for rate in (0.5, 0.25, 0.125):
            with engine.direct():
                want = call(rate)
            assert bit_equal(call(rate), want), (what, rate)
        assert engine.graph_counts()["captures"] == (
            0 if what == "fullfused" else 1), what


def test_kernel3_takes_its_rate_as_a_tensor():
    """The train step's wrapper takes a 0-d tensor rate: its plain version
    gives the bits of the number's."""
    _, tm, x, y = mlp_pair()
    x, y = torch.tensor(x), torch.tensor(y)
    ws, bs = list(tm.weights), list(tm.biases)
    a = K.fused_mlp_train_step(x, y, ws, bs, 0.3, tm.acts)
    b = K.fused_mlp_train_step(x, y, ws, bs, torch.tensor(0.3), tm.acts)
    assert bit_equal(list(a), list(b))


def test_a_rate_beside_bf16_tensors_keys_the_graph_on_its_value(
        graph_path):
    """Beside a bf16 tensor a rate is no 0-d tensor (its product would
    round the rate to bf16 on the card, where the direct call multiplies
    by the float32 number): each rate has its graph, bit-equal to the
    direct call, and a rate seen before replays its graph.  In float32 one
    graph takes every rate."""
    _, tm, x, y = mlp_pair()
    x, y = torch.tensor(x), torch.tensor(y)
    for model, rates, captures in ((tm.astype(torch.bfloat16),
                                    (0.5, 0.25, 0.5), 2),
                                   (tm, (0.5, 0.25, 0.5), 1)):
        engine.reset_graph_counts()
        for rate in rates:
            with engine.direct():
                want = model.train(rate, x, y)
            got = model.train(rate, x, y)
            assert bit_equal(got, want), (model.weights[0].dtype, rate)
        assert engine.graph_counts()["captures"] == captures
        assert engine.graph_counts()["replays"] == len(rates) - captures
    bf = tm.astype(torch.bfloat16)
    leaves = engine.flatten((0.5, x, bf.weights))
    assert not engine._traces_floats(leaves)
    assert engine._signature((0.5, x), False) != engine._signature(
        (0.25, x), False)
    assert engine._traces_floats(engine.flatten((0.5, x, tm.weights)))


class _FakeStream:
    """A CUDA stream of the card's (no card here): its priority and the
    streams it waited for."""

    def __init__(self, device=None, priority=0):
        self.device, self.priority = torch.device("cuda", 0), priority
        self.cuda_stream = id(self)

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


def test_every_graph_of_a_card_shares_its_capture_and_replay_streams(
        monkeypatch):
    """A compiled call's graph and a request graph are both captured on
    the card's one capture stream, which runs nothing else, and both warm
    up and replay on its one replay stream: no warm-up or replay writes
    the cuBLAS workspace of the capture stream, and the graphs that
    captured with it run one at a time.  The card's pool keeps one anchor
    graph, captured there once."""
    from tensor_ops_tpu_torch.models import serve as S

    default = _FakeStream()
    current = [default]
    made, log = [], []

    def new_stream(device=None, priority=0):
        made.append(_FakeStream(device, priority))
        return made[-1]

    @contextlib.contextmanager
    def on(stream):
        current.append(stream)
        yield
        current.pop()

    @contextlib.contextmanager
    def graph(g, capture_error_mode, stream=None, pool=None):
        log.append(("capture", stream, pool))
        yield

    class Graph:
        def replay(self):
            log.append(("replay", current[-1]))

    class Event:
        def record(self, stream=None):
            pass

    monkeypatch.setattr(engine, "_per_card", {})
    monkeypatch.setattr(engine, "_anchor", lambda device, stream, pool:
                        log.append(("anchor", stream, pool)))
    monkeypatch.setattr(torch.cuda, "Stream", new_stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current[-1])
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    card = torch.device("cuda", 0)

    def fn(commit):
        log.append(("fn", commit, current[-1]))
        return torch.zeros(1)

    compiled = engine._captured(fn, card, "a compiled call")
    def forward(x):
        log.append(("forward", current[-1]))
        return torch.zeros(1)

    request = S.RequestGraph(forward, type("X", (), {"device": card})(),
                             "a request")
    compiled.replay(2)
    request.replay()
    capture_stream, replay_stream, pool = engine._card(card)
    assert made == [capture_stream, replay_stream]
    assert capture_stream.priority == replay_stream.priority == -1
    assert compiled.stream is request.stream is replay_stream
    captures = [e for e in log if e[0] == "capture"]
    assert captures == [("capture", capture_stream, pool),
                        ("capture", capture_stream, None)]
    # the pool's anchor graph, captured once on the capture stream
    assert [e for e in log if e[0] == "anchor"] == [
        ("anchor", capture_stream, pool)]
    assert ("fn", False, replay_stream) in log
    assert ("fn", True, default) in log  # inside the capture
    assert [e for e in log if e[0] == "replay"] == [
        ("replay", replay_stream)] * 3
    assert [e for e in log if e[0] == "forward"] == [
        ("forward", replay_stream), ("forward", default)]
    assert all(e[-1] is not capture_stream for e in log
               if e[0] in ("fn", "forward"))


def test_a_new_shape_captures_once(graph_path):
    _, tnet, _, _ = ff_pair()
    run = TT.batched_run(tnet, TB)
    x, _, _ = ff_data(7)
    outs = {}
    for B in (3, 3, 5, 5, 3, 7, 5):
        out = run(TB.asarray(x[:B]), *tnet.params)
        if B in outs:
            assert torch.equal(out, outs[B])
        outs[B] = out
    assert engine.graph_counts()["captures"] == 3
    assert len(run.graphs) == 3
    # a dtype is part of the signature too
    run(TB.asarray(x[:3]).float(), *(p.float() for p in tnet.params))
    assert engine.graph_counts()["captures"] == 4


def test_the_lru_is_bounded(graph_path, monkeypatch):
    _, tnet, _, _ = ff_pair()
    run = TT.batched_run(tnet, TB)
    monkeypatch.setattr(run.graphs, "maxsize", 3)
    x, _, _ = ff_data(8)
    for B in (1, 2, 3, 4, 5):
        run(TB.asarray(x[:B]), *tnet.params)
    assert len(run.graphs) == 3
    assert engine.graph_counts()["captures"] == 5
    run(TB.asarray(x[:5]), *tnet.params)   # kept
    assert engine.graph_counts()["captures"] == 5
    run(TB.asarray(x[:1]), *tnet.params)   # evicted: captured again
    assert engine.graph_counts()["captures"] == 6
    assert run.graphs.maxsize == 3 and len(run.graphs) == 3


def test_the_default_bound_is_the_compiled_caches():
    from tensor_ops_tpu_torch.ops import ir

    for cache in (engine.jit(len).graphs, engine.Loop(len).graphs):
        assert isinstance(cache, ir.CompiledCache)
        assert cache.maxsize == ir.CompiledCache.DEFAULT_MAXSIZE == 128


def test_a_model_returned_earlier_is_left_untouched(graph_path):
    """Outputs are the caller's: the models of earlier calls keep their
    values after later replays (and so does the model trained from)."""
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(4)
    tx, ty = TB.asarray(x), TB.asarray(y)
    nets = [tnet]
    snaps = [[p.clone() for p in tnet.params]]
    for k in range(4):
        nets.append(nets[-1].train(tl, 0.5, TB, tx[k], ty[k]))
        snaps.append([p.clone() for p in nets[-1].params])
    for net, snap in zip(nets, snaps):
        assert all(torch.equal(p, s) for p, s in zip(net.params, snap))
    assert not torch.equal(nets[1].params[0], nets[3].params[0])
    _, tm, mx, my = mlp_pair()
    mx, my = torch.tensor(mx), torch.tensor(my)
    models = [tm]
    for _ in range(3):
        models.append(models[-1].train_fullfused(0.3, mx, my)[1])
    keep = [[p.clone() for p in m.to_params()] for m in models]
    models[-1].train_fullfused(0.3, mx, my)
    for m, snap in zip(models, keep):
        assert all(torch.equal(p, s) for p, s in zip(m.to_params(), snap))


def test_fused_models_keep_one_cache_across_steps(graph_path):
    _, tm, x, y = mlp_pair()
    x, y = torch.tensor(x), torch.tensor(y)
    m = tm
    for _ in range(3):
        _, m = m.train(0.1, x, y)
        _, m = m.train_fullfused(0.1, x, y)   # direct: no graph
    assert m._cache is tm._cache
    assert engine.graph_counts()["captures"] == 1
    assert tm.astype(torch.float64)._cache is tm._cache
    _, tr, xs, tg = rnn_fused("pallas")
    r = tr
    for _ in range(3):
        _, r = r.train(0.01, 0.001, xs, tg)
        r.seq_forward(xs)
    assert r._cache is tr._cache
    assert engine.graph_counts()["captures"] == 3
    _, tf, X = fae_pair()
    f = tf
    for _ in range(3):
        _, f = f.train(0.5, torch.tensor(X))
    assert f.mlp._cache is tf.mlp._cache
    assert engine.graph_counts()["captures"] == 3


def test_a_failed_capture_raises_and_never_runs_direct(monkeypatch):
    """A capture that fails raises ``CaptureError`` at every call: no call
    returns a direct result in its place, and no graph is kept."""
    def failing(fn, device, what="", remedy="", streams=None, pool=None):
        fn(False)
        raise engine.CaptureError(f"capturing {what} failed — {remedy}")

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(engine, "capture", failing)
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(2)
    tx, ty = TB.asarray(x), TB.asarray(y)
    for _ in range(2):
        with pytest.raises(engine.CaptureError, match="per-sample step.*never "
                           "runs direct"):
            tnet.train(tl, 0.5, TB, tx[0], ty[0])
    fn = tnet.op._compiled.get(("train", tl.struct_key()) + TB.cache_key())
    assert len(fn.graphs) == 0
    with pytest.raises(engine.CaptureError, match="fold"):
        TT.train_fold(tnet, tl, TB, 0.3, tx, ty)


def test_a_function_that_returns_a_number_cannot_be_captured(graph_path):
    f = engine.jit(lambda t: float(t.sum()), "a host read")
    with pytest.raises(engine.CaptureError, match="a host read.*float"):
        f(torch.ones(3))


def test_what_runs_direct_captures_nothing(graph_path, monkeypatch):
    """The explicit rules: CPU tensors (without the stand-in), the NumPy
    backend, ``Sharded`` leaves, NaN checks, inputs autograd records, a
    call inside another graph's function, and ``engine.direct``."""
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(3)
    tx, ty = TB.asarray(x), TB.asarray(y)

    def captures():
        return engine.graph_counts()["captures"]

    # NaN checks
    TP.enable_nan_checks(True)
    try:
        tnet.train(tl, 0.5, TB, tx[0], ty[0])
    finally:
        TP.enable_nan_checks(False)
    assert captures() == 0
    # Sharded leaves
    mesh = PM.Mesh(["cpu", "cpu"], ("data",))
    leaf = PM.place(torch.arange(4.0), (None,), mesh)
    f = engine.jit(lambda s, t: s.shards[0] + t, "a mesh call")
    assert torch.equal(f(leaf, torch.ones(4)), torch.arange(4.0) + 1)
    assert captures() == 0
    # autograd records the call
    w = tnet.params[0].clone().requires_grad_()
    out = TT.batched_run(tnet, TB)(tx, w, *tnet.params[1:])
    out.sum().backward()
    assert w.grad is not None and captures() == 0
    # inside another graph's function
    inner = engine.jit(lambda t: t * 2, "inner")
    outer = engine.jit(lambda t: inner(t) + 1, "outer")
    assert torch.equal(outer(torch.ones(2)), torch.full((2,), 3.0))
    assert torch.equal(outer(torch.ones(2)), torch.full((2,), 3.0))
    assert captures() == 1 and graph_path == ["outer"]
    assert len(inner.graphs) == 0
    # engine.direct
    with engine.direct():
        tnet.train(tl, 0.5, TB, tx[0], ty[0])
    assert captures() == 1
    # CPU tensors, the stand-in gone
    monkeypatch.setattr(engine, "uses_graphs",
                        lambda device: torch.device(device).type == "cuda")
    tnet.train(tl, 0.5, TB, tx[0], ty[0])
    TT.train_fold(tnet, tl, TB, 0.3, tx, ty)
    assert captures() == 1
    # the NumPy backend is never compiled
    nb = NumpyBackend()
    net_np = Network(tnet.op, tuple(p.numpy() for p in tnet.params))
    assert engine.maybe_jit(len, nb) is len
    TT.train_fold(net_np, tl, nb, 0.3, x, y)
    net_np.induce_many(tl, 1.0, nb, y[0], x[0], 3)
    assert captures() == 1


def test_cost_analysis_counts_the_same_work_through_the_graph_path(
        graph_path):
    """The counting mode runs a compiled call direct: the flops of a step
    are those of its function, the first call or any later one."""
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(5)
    tX, tY = TB.asarray(x), TB.asarray(y)

    def step():
        return TT.train_minibatch(tnet, tl, TB, 0.3, tX, tY)

    with engine.direct():
        want = TP.cost_analysis(step)
    step()
    step()
    got = TP.cost_analysis(step)
    assert got == want and got["flops"] > 0
    caps = engine.graph_counts()["captures"]
    TP.memory_analysis(step)
    assert engine.graph_counts()["captures"] == caps


def test_a_new_plan_epoch_recaptures(graph_path):
    """A graph keeps the kernels' plans it was captured with: after
    ``clear_plan_caches`` the next call captures anew."""
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(2)
    tx, ty = TB.asarray(x), TB.asarray(y)
    tnet.train(tl, 0.5, TB, tx[0], ty[0])
    tnet.train(tl, 0.5, TB, tx[0], ty[0])
    K.clear_plan_caches()
    tnet.train(tl, 0.5, TB, tx[0], ty[0])
    assert engine.graph_counts()["captures"] == 2


def test_threads_take_turns_on_a_graph(graph_path):
    """Concurrent calls of one signature: every result is its own rate's
    direct result."""
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(2)
    tx, ty = TB.asarray(x), TB.asarray(y)
    rates = [0.1 * (k + 1) for k in range(4)]
    with engine.direct():
        want = {r: tnet.train(tl, r, TB, tx[0], ty[0]) for r in rates}
    tnet.train(tl, 0.5, TB, tx[0], ty[0])  # captured
    bad = []

    def client(r):
        for _ in range(20):
            if not bit_equal(tnet.train(tl, r, TB, tx[0], ty[0]), want[r]):
                bad.append(r)

    threads = [threading.Thread(target=client, args=(r,)) for r in rates]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad and engine.graph_counts()["captures"] == 1


def test_loop_counts_replays_and_zero_steps(graph_path):
    _, tnet, _, tl = ff_pair()
    x, y, _ = ff_data(6)
    tx, ty = TB.asarray(x), TB.asarray(y)
    TT.train_fold(tnet, tl, TB, 0.3, tx, ty)
    assert engine.graph_counts() | {"capture_s": 0} == {
        "captures": 1, "capture_s": 0, "replays": 5}
    same = TT.train_fold(tnet, tl, TB, 0.3, tx[:0], ty[:0])
    assert all(p is q for p, q in zip(same.params, tnet.params))
    x0 = tx[0]
    assert tnet.induce_many(tl, 1.0, TB, ty[0], x0, 0) is x0
