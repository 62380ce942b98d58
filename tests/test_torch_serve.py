"""The port's serving path against the JAX package's, on the CPU.

A checkpoint written by one package is served by both, on the same numpy
inputs, through each ``Predictor`` route: the whole-network kernel (batch
5), the plain-matmul route (batch 70) and the per-layer kernel
(``use_fused_kernel=False``).  Probabilities agree to 1e-5 and classes
exactly.  A staged-IR ``Network`` served with its f64 backend agrees with
the JAX package's to 1e-9."""

import contextlib
import io

import numpy as np
import pytest
import torch

import apps.serve as j_app
import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_relu as j_relu
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models.fast import FusedMLP as JFusedMLP
from tensor_ops_tpu.models.serve import Predictor as JPredictor
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.apps import serve as t_app
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import FusedMLP, Network, Predictor
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_relu as t_relu
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.utils import checkpoint as TC

ATOL = 1e-5
HIDDEN = (300, 100)  # the flagship's widths
IN, OUT = 784, 10
BUCKETS = (8, 128)


def pixels(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, IN)) \
        .astype(np.float32)


def jax_flagship(seed=0, act=j_logistic):
    jb = T.JaxBackend()
    return j_gen_net(jb, IN, OUT, [(h, act()) for h in HIDDEN], j_softmax(),
                     JRng(jb, seed=seed))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ck") / "flagship.npz")
    JC.save_network(path, jax_flagship())
    return path


def port_model(path, device="cpu"):
    arrays, meta = TC.load_arrays(path)
    return t_app.load_model((arrays, meta), list(HIDDEN), IN, OUT,
                            "logistic", torch.device(device))


def jax_model(path):
    arrays, meta = JC.load_arrays(path)
    return j_app.load_model(path, list(HIDDEN), IN, OUT, False,
                            preloaded=(arrays, meta))


@pytest.mark.parametrize("n,fused", [(5, True), (70, True), (5, False)],
                         ids=["whole-net kernel", "matmul", "per-layer"])
def test_predictor_routes_match_jax(jax_ckpt, n, fused):
    x = pixels(1, n)
    jp = JPredictor(jax_model(jax_ckpt), buckets=BUCKETS,
                    use_fused_kernel=fused)
    tp = Predictor(port_model(jax_ckpt), buckets=BUCKETS,
                   use_fused_kernel=fused)
    want, got = jp.predict(x), tp.predict(x)
    assert got.shape == (n, OUT) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tp.predict_class(x), jp.predict_class(x))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=ATOL)
    one = tp.predict(x[0])
    np.testing.assert_allclose(one, got[0], atol=1e-6)
    assert tp.latency()["n"] == 3


def test_predictor_warmup_and_buckets(jax_ckpt):
    tp = Predictor(port_model(jax_ckpt), buckets=(4, 16))
    tp.warmup()
    x = pixels(2, 37)  # beyond the largest bucket: padded to 48
    direct = tp.model.run_xla(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(tp.predict(x), direct, atol=1e-6)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [l for l in buf.getvalue().splitlines() if l and l[0].isdigit()]


@pytest.mark.parametrize("extra", [[], ["--probs"], ["--bf16"],
                                   ["--bf16", "--probs"]],
                         ids=["classes", "probs", "bf16", "bf16-probs"])
def test_cli_matches_jax_cli(tmp_path, jax_ckpt, extra):
    xfile = str(tmp_path / "batch.npy")
    np.save(xfile, pixels(3, 6))
    common = [jax_ckpt, "-i", xfile, "--buckets", "8", *extra]
    want = _cli(j_app.main, common)
    got = _cli(t_app.main, common + ["--device", "cpu"])
    assert len(got) == len(want) == 6
    if "--probs" in extra:
        g = np.array([[float(v) for v in l.split(",")] for l in got])
        w = np.array([[float(v) for v in l.split(",")] for l in want])
        np.testing.assert_allclose(g, w, atol=ATOL)
    else:
        assert got == want


def test_cli_bench_prints_latency(jax_ckpt):
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_app.main([jax_ckpt, "--bench", "--buckets", "4,64",
                    "--device", "cpu"])
    line = [l for l in buf.getvalue().splitlines() if l.startswith("{")][-1]
    assert json.loads(line)["latency"]["n"] == 10


@pytest.mark.parametrize("argv,match", [
    (["--int8", "--bf16", "--bench"], "int8"),
    (["--bench", "--device", "cuda"], None),
    ([], None),
])
def test_cli_refuses(jax_ckpt, argv, match, capsys, monkeypatch):
    if "cuda" in argv:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        t_app.main([jax_ckpt, *argv] if "--device" in argv
                   else [jax_ckpt, *argv, "--device", "cpu"])
    err = capsys.readouterr().err
    assert (match or "") in err
    if "cuda" in argv:
        assert "CUDA is not available" in err


def test_cli_refuses_recurrent_checkpoint(tmp_path):
    path = str(tmp_path / "rnn.npz")
    JC.save_arrays(path, {"param_0": np.zeros(3)}, {"kind": "recurrent"})
    with pytest.raises(SystemExit):
        t_app.main([path, "--bench", "--device", "cpu"])


def test_checkpoints_cross_both_ways(tmp_path):
    # JAX save_network -> port load_network, bit-exact parameters
    jnet = jax_flagship(seed=4, act=j_relu)
    path = str(tmp_path / "j.npz")
    JC.save_network(path, jnet)
    tb = TorchBackend(torch.float32, "cpu")
    template = t_gen_net(tb, IN, OUT, [(h, t_logistic()) for h in HIDDEN],
                         t_softmax(), TRng(tb, 0))
    with pytest.raises(ValueError, match="activations"):
        TC.load_network(path, template, tb)  # relu checkpoint, logistic graph
    tnet = port_model(path)
    for a, b in zip(tnet.to_params(), jnet.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # port save_network -> JAX load_network + JAX serve
    tnet2 = t_gen_net(tb, IN, OUT, [(h, t_logistic()) for h in HIDDEN],
                      t_softmax(), TRng(tb, 5))
    path2 = str(tmp_path / "t.npz")
    TC.save_network(path2, tnet2)
    jb = T.JaxBackend()
    back = JC.load_network(path2, jax_flagship(), jb)
    for a, b in zip(back.params, tnet2.params):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = pixels(6, 5)
    want = JPredictor(JFusedMLP.from_network(back), buckets=(8,)).predict(x)
    got = Predictor(FusedMLP.from_network(tnet2), buckets=(8,)).predict(x)
    np.testing.assert_allclose(got, want, atol=ATOL)

    # FusedMLP checkpoints, both ways
    jfm = JFusedMLP.from_network(jnet)
    path3 = str(tmp_path / "jf.npz")
    JC.save_fused(path3, jfm)
    tfm = TC.load_fused(path3, device="cpu")
    assert tfm.acts == jfm.acts and tfm.softmax_out == jfm.softmax_out
    path4 = str(tmp_path / "tf.npz")
    TC.save_fused(path4, tfm)
    jfm2 = JC.load_fused(path4)
    for a, b in zip(jfm2.weights + jfm2.biases, jfm.weights + jfm.biases):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    served = _cli(t_app.main, [path4, "--bench", "--buckets", "4",
                               "--device", "cpu"])
    assert served == []  # bench prints JSON only


def test_from_numpy_matches_jax_fused():
    jfm = JFusedMLP.from_network(jax_flagship(seed=7))
    tfm = FusedMLP.from_numpy([np.asarray(w) for w in jfm.weights],
                              [np.asarray(b) for b in jfm.biases],
                              jfm.acts, jfm.softmax_out, device="cpu")
    x = pixels(8, 4)
    for t_run, j_run in ((tfm.run, jfm.run), (tfm.run_xla, jfm.run_xla),
                         (tfm.run_fused_inference, jfm.run_fused_inference)):
        np.testing.assert_allclose(t_run(torch.as_tensor(x)).numpy(),
                                   np.asarray(j_run(x)), atol=ATOL)
    assert [tuple(p.shape) for p in tfm.to_params()] == \
        [tuple(p.shape) for p in jfm.to_params()]


def test_reload_hot_swaps_and_keeps_dtype(jax_ckpt):
    x = pixels(9, 5)
    old, new = port_model(jax_ckpt), FusedMLP.from_network(
        t_gen_net(TorchBackend(torch.float32, "cpu"), IN, OUT,
                  [(h, t_logistic()) for h in HIDDEN], t_softmax(),
                  TRng(TorchBackend(torch.float32, "cpu"), 11)))
    p = Predictor(old, buckets=(8,), dtype="bf16")
    assert p.model.weights[0].dtype == torch.bfloat16
    before = p.predict(x)
    p.reload(new)
    assert p.model.weights[0].dtype == torch.bfloat16  # knob kept
    after = p.predict(x)
    want = Predictor(new, buckets=(8,), dtype="bf16").predict(x)
    np.testing.assert_array_equal(after, want)
    assert not np.allclose(before, after)
    p.reload(old, dtype=None)
    assert p.model.weights[0].dtype == torch.float32
    np.testing.assert_allclose(p.predict(x), Predictor(old, buckets=(8,))
                               .predict(x), atol=0)
    assert p.latency()["n"] == 3
    narrow = FusedMLP.from_numpy([np.zeros((3, IN))], [np.zeros(3)],
                                 ["identity"], device="cpu")
    with pytest.raises(ValueError, match="output width"):
        p.reload(narrow)


def test_bf16_predictor_matches_jax_bf16(jax_ckpt):
    x = pixels(10, 5)
    want = JPredictor(jax_model(jax_ckpt), buckets=(8,),
                      dtype="bf16").predict(x)
    got = Predictor(port_model(jax_ckpt), buckets=(8,),
                    dtype="bf16").predict(x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="dtype"):
        Predictor(port_model(jax_ckpt), dtype="int8")


def test_network_predictor_names_roadmap_item():
    """A Network is served only together with its backend, as in the JAX
    package (``tensor_ops_tpu/models/serve.py:89-90``)."""
    tb = TorchBackend(torch.float32, "cpu")
    net = t_gen_net(tb, 6, 3, [(4, t_logistic())], t_softmax(), TRng(tb, 0))
    with pytest.raises(ValueError, match="needs a backend"):
        Predictor(net)
    with pytest.raises(ValueError, match="dtype"):
        Predictor(net, tb, dtype="bf16")


@pytest.mark.parametrize("n", [3, 8, 21], ids=["padded", "bucket", "beyond"])
def test_network_predictor_matches_jax_network_predictor(n):
    """The same staged-IR Network (the JAX package's parameters copied
    across as numpy arrays) served by both Predictors with f64 backends."""
    import jax.numpy as jnp

    jb = T.JaxBackend(dtype=jnp.float64)
    jnet = j_gen_net(jb, 20, 4, [(12, j_logistic()), (7, j_relu())],
                     j_softmax(), JRng(jb, seed=3))
    tb = TorchBackend(torch.float64, "cpu")
    tmpl = t_gen_net(tb, 20, 4, [(12, t_logistic()), (7, t_relu())],
                     t_softmax(), TRng(tb, 0))
    tnet = Network(tmpl.op, [tb.asarray(np.asarray(p)) for p in jnet.params],
                   tmpl.act_names)
    x = np.random.default_rng(12).uniform(0, 1, size=(n, 20))
    jp = JPredictor(jnet, jb, buckets=(4, 8))
    tp = Predictor(tnet, tb, buckets=(4, 8))
    tp.warmup()
    want, got = jp.predict(x), tp.predict(x)
    assert got.shape == (n, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tp.predict_class(x), jp.predict_class(x))
    assert tp.be is tb and tp.model is tnet
    # a hot swap to the FusedMLP of the same weights keeps the interface
    tp.reload(FusedMLP.from_network(tnet))
    np.testing.assert_allclose(tp.predict(x), want, atol=ATOL)


def test_cpu_serving_launches_no_kernel(jax_ckpt):
    K.reset_launch_counts()
    for fused in (True, False):
        Predictor(port_model(jax_ckpt), buckets=(8,),
                  use_fused_kernel=fused).predict(pixels(11, 3))
    assert K.launch_counts() == {"fused_linear": 0, "fused_mlp_forward": 0,
                                 "fused_mlp_train_step": 0,
                                 "fused_linear_w8": 0, "fused_linear_w8a8": 0,
                                 "fused_mlp_w8a8_forward": 0,
                                 "fused_rnn_step": 0,
                                 "fused_rnn_step.seq": 0, "ring_all_reduce": 0,
                                 "bidir_ring": 0, "ring_all_reduce.ring": 0,
                                 "bidir_ring.ring": 0}
