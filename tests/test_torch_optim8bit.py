"""``adam8bit`` (block-wise absmax int8 moments) in the port, against the
JAX package's.

* The NumPy oracles: the port's update on NumPy arrays is bit-equal to the
  JAX package's in both rounding modes (the stochastic mode draws the same
  ``default_rng((salt, t, stream))`` noise).
* Torch tensors, nearest rounding: one update from the same state as the
  JAX package's jitted update gives the same int8 codes but for a share of
  at most 1e-6 in f64 and 1e-5 in f32 (measured here: 0 of 1,858,560 codes
  in f64 and 2 in f32, 1.1e-6, over the test's 30 updates),
  scales within two ulps (XLA's jitted step does not always round as
  torch's ops do); over a whole ``fit`` in f64 a code that flips at a rounding
  boundary moves the trajectory by one quantum, so 8 steps agree at 1e-9
  and 120 steps stay within 1e-3 of the JAX losses (measured 3.9e-5).
* Torch tensors, stochastic rounding: the noise comes from a
  ``torch.Generator`` seeded by (salt, step, leaf), not threefry, so it is
  held by its properties: a pure function of (step, leaf), uniform,
  unbiased rounding, and crash/resume bit-exact.
* The JAX tests of ``tests/test_optim8bit.py`` (single device) on the
  port."""

import jax
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
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.optim import _sr_uniform
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()


def task(n=256, seed=0):
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, 2))
    labels = (X[:, 0] * X[:, 1] > 0).astype(int)  # the dots quadrants
    return X, np.eye(2)[labels]


def jnet(seed=0):
    return j_gen_net(JB, 2, 2, [(16, j_logistic())], j_softmax(),
                     JRng(JB, seed=seed))


def tnet(be, jn):
    tmpl = t_gen_net(TB, 2, 2, [(16, t_logistic())], t_softmax(),
                     TRng(TB, 0))
    return Network(tmpl.op, tuple(be.asarray(np.asarray(p))
                                  for p in jn.params), tmpl.act_names)


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("sr", [False, True], ids=["nearest", "sr"])
def test_numpy_oracle_bit_equal_to_jax(sr):
    r = np.random.default_rng(0)
    params = (r.normal(size=(7, 5)), r.normal(size=(300,)))
    jo = JO.adam8bit(block=32, stochastic_rounding=sr)
    to = TO.adam8bit(block=32, stochastic_rounding=sr)
    js, ts = jo.init(params), to.init(params)
    jp = tp = params
    for i in range(20):
        g = tuple(r.normal(size=p.shape) * (0.1 + i) for p in params)
        js, jp = jo.update(js, jp, g, 0.01)
        ts, tp = to.update(ts, tp, g, 0.01)
    assert js[0] == ts[0] == 20
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    for jl, tl in zip(js[1], ts[1]):
        for a, b in zip(jl, tl):
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,share,ptol", [
    (torch.float64, 1e-6, 1e-12), (torch.float32, 1e-5, 1e-5)],
    ids=["f64", "f32"])
def test_torch_update_matches_jax_update(dtype, share, ptol):
    """Nearest rounding on torch tensors: each of 30 updates starts from
    the JAX package's state (its jitted update), and the codes it writes
    differ from the JAX codes in at most ``share`` of them; scales within
    two ulps, parameters within ``ptol`` and two ulps of their size."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ulp = float(torch.finfo(dtype).eps)
    r = np.random.default_rng(1)
    shapes = [(16, 2), (16,), (300, 100), (10,)]
    jo, to = JO.adam8bit(), TO.adam8bit()
    params = tuple(jnp.asarray(r.normal(size=s), jdt) for s in shapes)
    js = jo.init(params)
    upd = jax.jit(jo.update)
    differ = total = 0
    for _ in range(30):
        g = tuple(jnp.asarray(r.normal(size=s) * 10 ** r.uniform(-3, 0), jdt)
                  for s in shapes)
        ts = (int(js[0]), tuple(tuple(torch.from_numpy(np.array(x))
                                      for x in leaf) for leaf in js[1]))
        ts, tp = to.update(ts, tuple(torch.from_numpy(np.array(p))
                                     for p in params),
                           tuple(torch.from_numpy(np.array(x)) for x in g),
                           0.01)
        js, params = upd(js, params, g, 0.01)
        for (mq, ms, vq, vs), tl in zip(js[1], ts[1]):
            for code, t_code in ((mq, tl[0]), (vq, tl[2])):
                assert t_code.dtype == torch.int8
                differ += int((np.asarray(code) != t_code.numpy()).sum())
                total += t_code.numel()
            for s, t_s in ((ms, tl[1]), (vs, tl[3])):
                np.testing.assert_allclose(t_s.numpy(), np.asarray(s),
                                           rtol=2 * ulp, atol=0)
        for a, b in zip(params, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=2 * ulp, atol=ptol)
    assert differ <= share * total, (differ, total)


def test_fit_adam8bit_tracks_jax_fit():
    """The port's fit with adam8bit on TorchBackend(f64) against the JAX
    fit: 8 steps at 1e-9, then a trajectory that a flipped code moves by
    one quantum: 120 steps of losses within 1e-3, both learning."""
    X, Y = task()
    jn = jnet(1)
    kw = dict(epochs=30, batch_size=64, lr=0.02, verbose=False, prefetch=0,
              log_every=1)
    j = j_fit(jn, j_xent(2), JB, X, Y, optimizer=JO.adam8bit(), **kw)
    t = t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, optimizer=TO.adam8bit(),
              **kw)
    assert len(t.history) == len(j.history) == 120
    drift = [abs(a["loss"] - b["loss"]) for a, b in zip(t.history, j.history)]
    assert max(drift[:8]) <= 1e-9, drift[:8]
    assert max(drift) <= 1e-3, max(drift)
    assert t.history[-1]["loss"] < 0.5 * t.history[0]["loss"]


def test_adam8bit_converges_like_adam():
    X, Y = task()
    kw = dict(epochs=30, batch_size=64, lr=0.02, verbose=False,
              prefetch=0, log_every=10)
    jn = jnet(1)
    r8 = t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, optimizer=TO.adam8bit(),
               **kw)
    rf = t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, optimizer=TO.adam(), **kw)
    l8, lf = r8.history[-1]["loss"], rf.history[-1]["loss"]
    l0 = r8.history[0]["loss"]
    assert l8 < 0.5 * l0, (l0, l8)             # it learns
    assert l8 < max(2.0 * lf, 0.05), (l8, lf)  # and tracks f32 adam


@pytest.mark.parametrize("be", [TorchBackend(torch.float32, "cpu"), TNB],
                         ids=["torch", "numpy"])
def test_adam8bit_state_is_int8_and_small(be):
    net = tnet(be, jnet())
    opt = TO.adam8bit(block=64)
    params = tuple(net.params)
    t, qs = opt.init(params)
    assert t == 0
    total_code_bytes = 0
    for (mq, ms, vq, vs), p in zip(qs, params):
        assert host(mq).dtype == np.int8 and host(vq).dtype == np.int8
        assert host(ms).dtype == host(p).dtype
        assert mq.shape[1] == 64 and tuple(ms.shape) == (mq.shape[0], 1)
        total_code_bytes += host(mq).size + host(vq).size
    n_param = sum(host(p).size for p in params)
    assert total_code_bytes <= 2 * (n_param + 64 * len(params))

    grads = tuple(p * 0 + 0.01 for p in params)
    (t1, qs1), new_p = opt.update((t, qs), params, grads, 0.1)
    assert t1 == 1
    for a, b in zip(new_p, params):
        assert not np.allclose(host(a), host(b))
    for mq, ms, vq, vs in qs1:
        assert np.all(np.isfinite(host(ms)))
        assert host(mq).dtype == np.int8


def test_adam8bit_numpy_backend():
    """The NumPy oracle trains with adam8bit through fit."""
    X, Y = task(n=64)
    res = t_fit(tnet(TNB, jnet(2)), t_xent(2), TNB, X, Y, epochs=2,
                batch_size=32, lr=0.02, optimizer=TO.adam8bit(block=32),
                verbose=False, prefetch=0, log_every=1)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert res.history[-1]["loss"] < res.history[0]["loss"] * 1.5
    assert all(isinstance(p, np.ndarray) for p in res.net.params)


def _resume_chain(tmp_path, opt):
    X, Y = task(n=128)
    ck = str(tmp_path / "a8.npz")
    kw = dict(batch_size=32, lr=0.02, optimizer=opt, verbose=False,
              prefetch=0, log_every=1)
    jn = jnet(3)
    t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, epochs=1, checkpoint_path=ck,
          checkpoint_every=2, **kw)
    resumed = t_fit(tnet(TB, jnet(4)), t_xent(2), TB, X, Y, epochs=2,
                    checkpoint_path=ck, checkpoint_every=2, resume=True, **kw)
    straight = t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, epochs=2, **kw)
    assert resumed.steps == straight.steps == 8
    assert all(np.isfinite(h["loss"]) for h in straight.history)
    for a, b in zip(resumed.net.params, straight.net.params):
        assert torch.equal(a, b)
    return ck


def test_adam8bit_resume_bit_exact(tmp_path):
    """The int8 codes round-trip the .state file: crash/resume equals the
    uninterrupted run bit for bit, and the saved codes are int8."""
    ck = _resume_chain(tmp_path, TO.adam8bit())
    arrays, meta = TC.load_arrays(ck + ".state")
    assert arrays["o_1"].dtype == np.int8 and meta["n_opt_leaves"] == 17


def test_adam8bit_sr_resume_bit_exact_and_footprint(tmp_path):
    """The torch stream of the stochastic rounding is a pure function of
    (step, leaf): crash/resume chains are bit-identical; the layout and
    footprint are those of nearest rounding, the key is not."""
    opt = TO.adam8bit(stochastic_rounding=True)
    assert TO.moment_footprint(opt, 8) == TO.moment_footprint(
        TO.adam8bit(), 8)
    assert opt.struct_key() != TO.adam8bit().struct_key()
    assert opt.struct_key() == JO.adam8bit(
        stochastic_rounding=True).struct_key()
    _resume_chain(tmp_path, opt)


def test_adam8bit_memory_accounting():
    """moment_footprint charges adam8bit a byte a code plus its block's
    share of a scale, as the JAX package's does, for every optimizer."""
    for bytes_per in (4, 8):
        for t_opt, j_opt in ((None, None), (TO.sgd(), JO.sgd()),
                             (TO.momentum(), JO.momentum()),
                             (TO.adam(), JO.adam()),
                             (TO.adamw(), JO.adamw()),
                             (TO.adam8bit(), JO.adam8bit()),
                             (TO.adam8bit(block=32), JO.adam8bit(block=32))):
            assert TO.moment_footprint(t_opt, bytes_per) == \
                JO.moment_footprint(j_opt, bytes_per)
        assert TO.moment_footprint(TO.adam8bit(block=256), bytes_per) == \
            2 * (1 + bytes_per / 256)


def _stalled_run(opt, xp, steps=10_000):
    """The JAX test's separable quadratic: one block of 256, element 0
    with a large gradient, the rest tiny."""
    n = 256
    g_scale = np.full(n, 1e-3)
    g_scale[0] = 1.0
    w = (xp(np.ones(n)),)
    gs = xp(g_scale)
    st = opt.init(w)
    for _ in range(steps):
        st, w = opt.update(st, w, (gs * w[0],), 0.01)
    return host(w[0]), g_scale


@pytest.mark.parametrize("xp", [np.asarray,
                                lambda a: torch.as_tensor(a)],
                         ids=["numpy", "torch"])
def test_adam8bit_sr_unbiased_and_rescues_stalled_moments(xp):
    """Nearest rounding drops a moment increment below half a quantum
    forever (the small coordinates stall); stochastic rounding keeps it in
    expectation: over 10k steps its loss tracks f32 adam, with the NumPy
    stream and with the torch stream."""
    w_adam, g_scale = _stalled_run(TO.adam(), xp)
    w_det, _ = _stalled_run(TO.adam8bit(), xp)
    w_sr, _ = _stalled_run(TO.adam8bit(stochastic_rounding=True), xp)

    def loss(w):
        return float(np.sum(g_scale * w ** 2))

    assert loss(w_adam) < 1e-6
    gap_sr = loss(w_sr) - loss(w_adam)
    gap_det = loss(w_det) - loss(w_adam)
    assert gap_sr < 0.05, f"SR drifted from adam: {gap_sr}"
    assert gap_sr < 0.2 * gap_det, (gap_sr, gap_det)
    assert np.abs(w_sr[1:]).mean() < 0.5 * np.abs(w_det[1:]).mean()


def test_torch_sr_noise_properties():
    """The torch noise: a pure function of (step, leaf stream) (the same
    pair gives the same bits, another pair other bits), uniform on [0, 1),
    and floor(y + u) rounds y without bias."""
    like = torch.zeros(64, 256, dtype=torch.float64)
    a = _sr_uniform(7, 3, like)
    assert torch.equal(a, _sr_uniform(7, 3, like))
    assert not torch.equal(a, _sr_uniform(8, 3, like))
    assert not torch.equal(a, _sr_uniform(7, 4, like))
    assert a.dtype == like.dtype and a.shape == like.shape
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.01  # 16,384 draws: sd 0.0023
    y = torch.linspace(-3, 3, 256, dtype=torch.float64).expand(64, 256)
    rounded = torch.stack([torch.floor(y + _sr_uniform(t, 0, like))
                           for t in range(1, 65)])
    # 4,096 draws per value, each within 1 of it: sd <= 0.008
    assert float((rounded.mean(dim=(0, 1)) - y[0]).abs().max()) < 0.05


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adam8bit_state_resumes_across_packages(tmp_path, writer):
    """A ``.state`` holding adam8bit's int8 codes, written by one package's
    fit, resumes in the other's: 4 more steps, within 1e-9 of the writer's
    straight run."""
    X, Y = task(n=128)
    ck = str(tmp_path / f"{writer}.npz")
    kw = dict(batch_size=32, lr=0.02, verbose=False, log_every=1)
    jn = jnet(6)
    if writer == "jax":
        j_fit(jn, j_xent(2), JB, X, Y, epochs=1, optimizer=JO.adam8bit(),
              checkpoint_path=ck, checkpoint_every=4, **kw)
        straight = j_fit(jn, j_xent(2), JB, X, Y, epochs=2,
                         optimizer=JO.adam8bit(), **kw)
        resumed = t_fit(tnet(TB, jnet(7)), t_xent(2), TB, X, Y, epochs=2,
                        optimizer=TO.adam8bit(), checkpoint_path=ck,
                        resume=True, **kw)
    else:
        t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, epochs=1,
              optimizer=TO.adam8bit(), checkpoint_path=ck,
              checkpoint_every=4, **kw)
        straight = t_fit(tnet(TB, jn), t_xent(2), TB, X, Y, epochs=2,
                         optimizer=TO.adam8bit(), **kw)
        resumed = j_fit(jnet(7), j_xent(2), JB, X, Y, epochs=2,
                        optimizer=JO.adam8bit(), checkpoint_path=ck,
                        resume=True, **kw)
    assert resumed.steps == straight.steps == 8
    for a, b in zip(resumed.history, straight.history[4:]):
        assert abs(a["loss"] - b["loss"]) <= 1e-9
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_allclose(host(a), host(b), rtol=0, atol=1e-9)


def test_exact_reduction_keys_the_optimizer_only():
    """exact_reduction changes nothing on one device but the keys: the
    same update, the JAX package's struct_key."""
    opt = TO.adam8bit(exact_reduction=True)
    assert opt.exact_reduction and not TO.adam8bit().exact_reduction
    assert opt.struct_key() == JO.adam8bit(exact_reduction=True).struct_key()
    assert opt.struct_key() != TO.adam8bit().struct_key()
    r = np.random.default_rng(2)
    params = (torch.as_tensor(r.normal(size=(9, 40))),)
    grads = (torch.as_tensor(r.normal(size=(9, 40))),)
    a = opt.update(opt.init(params), params, grads, 0.1)
    b = TO.adam8bit().update(TO.adam8bit().init(params), params, grads, 0.1)
    assert torch.equal(a[1][0], b[1][0])
    assert all(torch.equal(x, y) for x, y in zip(a[0][1][0], b[0][1][0]))
