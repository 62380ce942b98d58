"""The port's recurrent serving against the JAX package's, on the CPU:
``SequencePredictor`` (bucketing on the batch axis, a lone sequence,
warm-up, the atomic ``reload``, the bounded op cache) and the serve app's
recurrent route (stored ``arch``, ``--probs`` trajectories, ``--bench``,
refusals, checkpoints written by either package).

Networks are built by the JAX package and carried across with
``recurrent_from_arrays``; inputs are numpy arrays from a seed.
Tolerances: 1e-9 for ``SequencePredictor`` in float64 (the JAX package's
parity bound); the apps serve in float32 and print 6 decimals, so their
lines are held to 1e-6 (f32 sums in another order, ~1e-7, plus half a unit
of the last printed digit on each side)."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import apps.serve as j_app
import tensor_ops_tpu as T
import tensor_ops_tpu.models.recurrent as JR
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models.serve import SequencePredictor as JSeqPredictor
from tensor_ops_tpu.utils import checkpoint as JC
import tensor_ops_tpu_torch.models.recurrent as TR
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.apps import serve as t_app
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import SequencePredictor
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.ops.ir import CompiledCache
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-9
APP_TOL = 1e-6


@pytest.fixture(scope="module")
def tb():
    return TorchBackend(torch.float64, "cpu")


def jax_rnet(be, seed, i=2, o=1, h=5, out_sact=None):
    lg = j_logistic
    return JR.gen_net(be, i, o, [(h, lg(), lg())], lg(),
                      lg() if out_sact else None, JRng(be, seed=seed))


def port_of(jnet, be):
    """The port's gen_net of ``jnet``'s arch, carrying its weights."""
    arch = jnet.arch
    lg = t_logistic
    template = TR.gen_net(be, arch["in"], arch["out"],
                          [(h, lg(), lg()) for h in arch["sizes"]], lg(),
                          lg() if arch["state_acts"][-1] else None,
                          TRng(be, seed=0))
    arrays, meta = JC._recurrent_payload(jnet, None)
    return TC.recurrent_from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, template, be)


def seqs(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, size=shape) \
        .astype(np.float32)


def test_sequence_predictor_matches_jax(jb, tb):
    """A ragged batch of 3 rides the 4-bucket; a lone sequence is
    auto-batched; both equal the JAX SequencePredictor and the port's own
    per-sequence ``run_seq``."""
    jnet = jax_rnet(jb, seed=1)
    tnet = port_of(jnet, tb)
    jp = JSeqPredictor(jnet, jb, buckets=(4,))
    tp = SequencePredictor(tnet, tb, buckets=(4,))
    xs = seqs(0, 3, 6, 2)
    out = tp.predict(xs)
    assert out.shape == (3, 6, 1)
    np.testing.assert_allclose(out, jp.predict(xs), rtol=0, atol=TOL)
    for i in range(3):
        want, _ = tnet.run_seq(tb, tb.asarray(xs[i]))
        np.testing.assert_allclose(out[i], want.numpy(), rtol=0, atol=TOL)
    single = tp.predict(xs[0])
    np.testing.assert_allclose(single, out[0], rtol=0, atol=TOL)
    assert tp.latency()["n"] == 2


def test_warmup_and_reload_keep_warmed_lengths(jb, tb):
    """``warmup`` runs every (bucket, length) pair; ``reload`` warms the
    union of warmed lengths and extras for the replacement before the swap,
    changes the predictions, and refuses an interface change
    (``test_sequence_predictor_reload``, ``..._reload_warms_union``)."""
    def rnet(seed, i=1):
        return port_of(jax_rnet(jb, seed=seed, i=i, h=6), tb)

    pred = SequencePredictor(rnet(0), tb, buckets=(2, 8))
    pred.warmup([3, 5])
    xs = seqs(2, 3, 5, 1)
    out_a = pred.predict(xs)
    n_before = pred.latency()["n"]
    new = rnet(1)
    pred.reload(new, warm_lengths=[7])
    assert pred._warmed == {3, 5, 7}
    for n in (3, 5, 7):
        assert ("serve_seq", n) + tb.cache_key() in new.op._compiled
    out_b = pred.predict(xs)
    assert not np.allclose(out_a, out_b)
    assert pred.latency()["n"] == n_before + 1
    jp = JSeqPredictor(jax_rnet(jb, seed=1, i=1, h=6), jb, buckets=(2, 8))
    np.testing.assert_allclose(out_b, jp.predict(xs), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="input shape"):
        pred.reload(rnet(3, i=2))


def test_cycling_sequence_lengths_keeps_the_cache_bounded(tb):
    """100 sequence lengths through one predictor: the op's cache stays
    within its LRU bound and the hot key stays cached
    (``tests/test_cache_keys.py:191``)."""
    rnet = TR.fully_connected(t_logistic(), tb, 3, 3, TRng(tb, seed=0))
    pred = SequencePredictor(rnet, tb, buckets=(1,))
    cache = rnet.op._compiled
    assert isinstance(cache, CompiledCache)
    pred.predict(np.zeros((1, 2, 3), np.float32))  # the hot key: length 2
    hot = [k for k in cache if isinstance(k, tuple) and k[0] == "serve_seq"]
    assert len(hot) == 1
    hot_fn = cache.get(hot[0])
    for n in range(3, 103):
        pred.predict(np.zeros((1, n, 3), np.float32))
        cache.get(hot[0])  # a production hot path touches its key
    assert len(cache) <= cache.maxsize
    assert cache.get(hot[0]) is hot_fn


# -- the serve app's recurrent route ------------------------------------------


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _numbers(lines):
    return np.array([[float(v) for v in l.split(",")] for l in lines
                     if l and (l[0].isdigit() or l[0] == "-")])


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("rnn")
    be = T.JaxBackend()
    path = str(d / "rnn.npz")
    JC.save_recurrent(path, jax_rnet(be, seed=7, out_sact=True))
    xfile = str(d / "seqs.npy")
    np.save(xfile, seqs(0, 3, 6, 2))
    return path, xfile


@pytest.mark.parametrize("extra", [[], ["--probs"]],
                         ids=["last-step", "trajectories"])
def test_app_serves_a_jax_checkpoint_as_the_jax_app_does(jax_ckpt, extra):
    """No architecture flags: the stored ``arch`` rebuilds the graph; the
    lines equal the JAX app's (one per sequence, or one per timestep with
    ``--probs``)."""
    path, xfile = jax_ckpt
    argv = [path, "--buckets", "4", "-i", xfile, *extra]
    want = _numbers(_lines(j_app.main, argv))
    got = _numbers(_lines(t_app.main, argv + ["--device", "cpu"]))
    assert got.shape == want.shape == ((3 * 6, 1) if extra else (3, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=APP_TOL)


def test_app_bench_prints_latency(jax_ckpt):
    path, _ = jax_ckpt
    lines = _lines(t_app.main, [path, "--buckets", "2", "--bench",
                                "--seq-len", "6", "--device", "cpu"])
    assert "RecurrentNetwork" in lines[0] and "cpu" in lines[0]
    assert json.loads(lines[-1])["latency"]["n"] == 5


@pytest.mark.parametrize("argv", [["--int8"], ["--bf16"]])
def test_app_refuses_int8_and_bf16_on_a_recurrent_checkpoint(jax_ckpt, argv,
                                                             capsys):
    path, xfile = jax_ckpt
    with pytest.raises(SystemExit):
        t_app.main([path, "-i", xfile, "--device", "cpu", *argv])
    assert "recurrent" in capsys.readouterr().err


def test_app_rebuilds_old_checkpoints_from_flags(tmp_path, jax_ckpt):
    """A checkpoint without ``arch`` rebuilds from the flags; a wrong
    architecture dies cleanly (SystemExit, not a KeyError)."""
    path, xfile = jax_ckpt
    arrays, meta = TC.load_arrays(path)
    meta.pop("arch")
    old = str(tmp_path / "old.npz")
    TC.save_arrays(old, arrays, meta)
    common = ["--in-dim", "2", "--out-dim", "1", "--buckets", "4", "-i", xfile,
              "--device", "cpu"]
    got = _numbers(_lines(t_app.main, [old, "--layers", "5", *common]))
    want = _numbers(_lines(t_app.main, [path, "--device", "cpu", "--buckets",
                                        "4", "-i", xfile]))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        with contextlib.redirect_stdout(io.StringIO()):
            t_app.main([old, "--layers", "5,5", *common])


def test_port_checkpoint_serves_in_the_jax_app(tmp_path):
    """A checkpoint the port saves loads in the JAX loader and serves the
    same lines from both apps."""
    be = TorchBackend(torch.float32, "cpu")
    tnet = TR.gen_net(be, 3, 2, [(4, t_logistic(), t_logistic())],
                      t_logistic(), None, TRng(be, seed=5))
    path = str(tmp_path / "port.npz")
    TC.save_recurrent(path, tnet)
    xfile = str(tmp_path / "x.npy")
    np.save(xfile, seqs(9, 2, 4, 3))
    argv = [path, "--buckets", "2", "-i", xfile, "--probs"]
    want = _numbers(_lines(j_app.main, argv))
    got = _numbers(_lines(t_app.main, argv + ["--device", "cpu"]))
    assert got.shape == (2 * 4, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=APP_TOL)
