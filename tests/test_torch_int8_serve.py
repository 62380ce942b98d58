"""The port's int8 serving slice against the JAX package's, on the CPU:
``QuantizedMLP`` in both modes, the quantized checkpoints both ways, the
``Predictor`` routes and the serve app's ``--int8``; plus the port's
entry-point defaults and the kernel build hash.

Tolerances, with their reasons (see also ``tests/test_torch_int8.py``):

* Codes, scales and checkpoint arrays compare exactly.
* The port's own routes that compute the same ops in the same order (the
  whole-MLP route and the per-layer chain; bucket padding, which adds
  all-zero rows to a per-row quantizer) compare bit for bit.
* w8 against the JAX package: the same bf16-rounded operands summed in
  another order, 1e-6.
* w8a8 against the JAX package, with logistic hidden layers: XLA fuses the
  epilogue's last multiply-add into an FMA and computes the logistic by
  another formula, so a hidden value may differ by an ulp; if that moves it
  across a .5 code boundary, one code of the next layer flips.  A hidden
  logistic layer's values lie in [0, 1], so its row scale is at most 1/127,
  and one flipped code moves a logit of the last layer by at most
  ``(1/127) * 127 * sw = sw``, the last layer's largest weight scale; a
  probability moves by no more than the logit does.  That one-code step is
  the tolerance.
* The app prints probabilities with 6 decimals: half a unit of the last
  digit (5e-7) on top.
"""

import contextlib
import inspect
import io
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apps.serve as j_app
import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models.fast import FusedMLP as JFusedMLP
from tensor_ops_tpu.models.fast import QuantizedMLP as JQuantizedMLP
from tensor_ops_tpu.models.serve import Predictor as JPredictor
from tensor_ops_tpu.ops import pallas_kernels as PK
from tensor_ops_tpu.testing import rand as r
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.apps import serve as t_app
from tensor_ops_tpu_torch.models import FusedMLP, Predictor, QuantizedMLP
from tensor_ops_tpu_torch.ops import cuda_build
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

PRINT_ROUNDING = 5e-7


def jax_net(seed, dims=(10, 8, 4)):
    jb = T.JaxBackend()
    return j_gen_net(jb, dims[0], dims[-1],
                     [(h, j_logistic()) for h in dims[1:-1]], j_softmax(),
                     JRng(jb, seed=seed))


def port_fused(jfm):
    return FusedMLP.from_numpy([np.asarray(w) for w in jfm.weights],
                               [np.asarray(b) for b in jfm.biases],
                               jfm.acts, jfm.softmax_out, device="cpu")


def port_quantized(jqm):
    return QuantizedMLP.from_numpy(
        [np.asarray(q) for q in jqm.wqs], [np.asarray(s) for s in jqm.scales],
        [np.asarray(b) for b in jqm.biases], jqm.acts, jqm.softmax_out,
        jqm.mode, device="cpu")


def code_step(qm) -> float:
    """The one-code-step tolerance of the module docstring."""
    return float(max(np.asarray(qm.scales[-1]).max(), 1e-6))


def pixels(seed, n, width):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, width)) \
        .astype(np.float32)


def uniform_jax_quantized(seed, acts, N=128, softmax_out=True):
    ws = [jnp.asarray(r(seed + k, N, N) * 0.2, jnp.float32)
          for k in range(len(acts))]
    bs = [jnp.asarray(r(seed + 10 + k, N) * 0.1, jnp.float32)
          for k in range(len(acts))]
    qs, ss = zip(*(PK.quantize_weights_int8(w) for w in ws))
    return JQuantizedMLP(tuple(qs), tuple(ss), tuple(bs), tuple(acts),
                         softmax_out=softmax_out)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_mlp_from_fused_matches_jax(mode):
    """Counterpart of ``test_pallas.py:282-297``: the codes are the JAX
    package's, and ``run`` agrees with the JAX ``QuantizedMLP.run``."""
    jfm = JFusedMLP.from_network(jax_net(0), precision="highest")
    jqm = JQuantizedMLP.from_fused(jfm, mode=mode)
    tqm = QuantizedMLP.from_fused(port_fused(jfm), mode=mode)
    assert tqm.mode == mode and tqm.device == torch.device("cpu")
    for a, b in zip(tqm.wqs + tqm.scales, jqm.wqs + jqm.scales):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tqm.wqs[0].dtype == torch.int8
    x = r(24, 5, 10).astype(np.float32)
    want = np.asarray(jqm.run(jnp.asarray(x)))
    got = tqm.run(torch.tensor(x)).numpy()
    tol = 1e-6 if mode == "w8" else code_step(tqm)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    pf = np.asarray(jfm.run(jnp.asarray(x)))
    assert (pf.argmax(axis=1) == got.argmax(axis=1)).all()
    np.testing.assert_allclose(got, pf, atol=0.05)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_mlp_from_numpy_carries_jax_arrays(mode):
    jqm = JQuantizedMLP.from_fused(
        JFusedMLP.from_network(jax_net(1, (12, 9, 7, 4))), mode=mode)
    tqm = port_quantized(jqm)
    assert [tuple(q.shape) for q in tqm.wqs] == [q.shape for q in jqm.wqs]
    x = pixels(2, 6, 12)
    tol = 1e-6 if mode == "w8" else code_step(tqm)
    np.testing.assert_allclose(tqm.run(torch.tensor(x)).numpy(),
                               np.asarray(jqm.run(jnp.asarray(x))), atol=tol)
    with pytest.raises(ValueError, match="mode"):
        QuantizedMLP(tqm.wqs, tqm.scales, tqm.biases, tqm.acts, mode="w4")
    with pytest.raises(ValueError, match="int8"):
        QuantizedMLP(tuple(q.float() for q in tqm.wqs), tqm.scales,
                     tqm.biases, tqm.acts)


def test_run_fused_matches_jax_and_run():
    """Counterpart of ``test_pallas.py:261-279`` at N=128, L=3."""
    jqm = uniform_jax_quantized(70, ("logistic", "logistic", "identity"))
    tqm = port_quantized(jqm)
    assert tqm.uniform()
    x = r(90, 4, 128).astype(np.float32)
    got = tqm.run_fused(torch.tensor(x))
    assert torch.equal(got, tqm.run(torch.tensor(x)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jqm.run_fused(jnp.asarray(x))),
                               rtol=0, atol=code_step(tqm))
    bad = QuantizedMLP(tqm.wqs[:1] + (tqm.wqs[1][:64],),
                       tqm.scales[:1] + (tqm.scales[1][:64],),
                       tqm.biases[:1] + (tqm.biases[1][:64],),
                       ("relu", "identity"))
    assert not bad.uniform()
    with pytest.raises(ValueError, match="uniform"):
        bad.run_fused(torch.tensor(x))
    mixed = QuantizedMLP(tqm.wqs, tqm.scales, tqm.biases,
                         ("relu", "tanh", "identity"))
    with pytest.raises(ValueError, match="one hidden activation"):
        mixed.run_fused(torch.tensor(x))


def test_run_fused_applies_final_activation():
    """Counterpart of ``test_pallas.py:485-502``: with softmax_out=False the
    kernel gives raw logits and run_fused applies acts[-1]."""
    jqm = uniform_jax_quantized(95, ("relu", "relu"), softmax_out=False)
    tqm = port_quantized(jqm)
    x = r(99, 4, 128).astype(np.float32)
    got = tqm.run_fused(torch.tensor(x))
    assert (got >= 0).all()
    assert torch.equal(got, tqm.run(torch.tensor(x)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jqm.run_fused(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_uniform_stack_is_held_once():
    """The (L, N, N) stack is made once per model, and the per-layer codes
    are its views: no second copy of the weights."""
    tqm = port_quantized(uniform_jax_quantized(71, ("relu", "identity")))
    stack = tqm._cache["stacked"][0]
    assert tuple(stack.shape) == (2, 128, 128)
    for k, q in enumerate(tqm.wqs):
        assert q.data_ptr() == stack[k].data_ptr()
    assert tqm._padded() is tqm._padded()  # cached once, too


@pytest.mark.parametrize("checkpoint_from", ["jax", "port"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_checkpoints_cross_both_ways(tmp_path, mode,
                                               checkpoint_from):
    """Counterpart of ``tests/test_utils.py:154-175``: the same keys and
    meta, int8 codes stay int8 in the file, mode and acts survive."""
    jqm = JQuantizedMLP.from_fused(
        JFusedMLP.from_network(jax_net(2, (8, 6, 4))), mode=mode)
    path = str(tmp_path / "q.npz")
    if checkpoint_from == "jax":
        JC.save_quantized(path, jqm)
    else:
        TC.save_quantized(path, port_quantized(jqm))
    with np.load(path) as z:
        assert sorted(k for k in z.files if k != "__meta__") == sorted(
            [f"{p}_{i}" for p in ("wq", "s", "b") for i in range(2)])
        assert z["wq_0"].dtype == np.int8 and z["s_0"].dtype == np.float32
    tqm = TC.load_quantized(path, device="cpu")
    jqm2 = JC.load_quantized(path)
    for back in (tqm, jqm2):
        assert back.mode == mode and tuple(back.acts) == jqm.acts
        assert back.softmax_out == jqm.softmax_out
    for a, b, c in zip(tqm.wqs + tqm.scales + tqm.biases,
                       jqm.wqs + jqm.scales + jqm.biases,
                       jqm2.wqs + jqm2.scales + jqm2.biases):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(b))
        assert np.asarray(c).dtype == np.asarray(b).dtype
    assert tqm.wqs[0].dtype == torch.int8


def test_predictor_quantized_pads_buckets_exactly():
    """Counterpart of ``tests/test_serve.py:50-84``: bucket padding adds
    all-zero rows, which a per-row quantizer leaves out of every other
    row's codes, so the served output equals the bare model's bit for bit;
    int8 and f32 classes mostly agree; the JAX Predictor agrees to one
    code step."""
    jfm = JFusedMLP.from_network(jax_net(3, (12, 10, 4)), precision="highest")
    tfm = port_fused(jfm)
    tqm = QuantizedMLP.from_fused(tfm)
    pf = Predictor(tfm, buckets=(4, 16))
    pq = Predictor(QuantizedMLP.from_fused(tfm), buckets=(4, 16))
    jq = JPredictor(JQuantizedMLP.from_fused(jfm), buckets=(4, 16))
    pq.warmup()
    agree = total = 0
    for n in (1, 4, 9, 16, 33):
        x = pixels(n, n, 12)
        got = pq.predict(x)
        np.testing.assert_array_equal(got, tqm.run(torch.tensor(x)).numpy())
        np.testing.assert_allclose(got, jq.predict(x), rtol=0,
                                   atol=code_step(tqm))
        agree += int((pf.predict_class(x) == pq.predict_class(x)).sum())
        total += n
    assert agree / total > 0.8, (agree, total)
    assert pq.latency()["n"] >= 10


@pytest.mark.parametrize("fused", [True, False])
def test_predictor_quantized_uniform_route(fused):
    """Counterpart of ``tests/test_serve.py:87-107``: a uniform 128-multiple
    stack routes to ``run_fused``; ``use_fused_kernel=False`` to ``run``."""
    jqm = uniform_jax_quantized(72, ("relu", "identity"))
    tqm = port_quantized(jqm)
    p = Predictor(tqm, buckets=(8,), use_fused_kernel=fused)
    assert p._serving[2] is fused
    calls = []
    for name in ("run", "run_fused"):
        orig = getattr(QuantizedMLP, name)

        def spy(self, x, orig=orig, name=name):
            calls.append(name)
            return orig(self, x)

        setattr(tqm, name, spy.__get__(tqm))
    x = pixels(5, 5, 128)
    out = p.predict(x)
    assert calls[0] == ("run_fused" if fused else "run")
    np.testing.assert_array_equal(
        out, QuantizedMLP.run_fused(tqm, torch.tensor(x)).numpy())
    jp = JPredictor(jqm, buckets=(8,), use_fused_kernel=fused)
    np.testing.assert_allclose(out, jp.predict(x), rtol=1e-5, atol=1e-5)


def test_predictor_quantized_refuses_dtype():
    tqm = port_quantized(uniform_jax_quantized(73, ("relu", "identity")))
    with pytest.raises(ValueError, match="dtype"):
        Predictor(tqm, dtype="bf16")


def test_predictor_bf16_reload_quantized_then_back():
    """Counterpart of ``tests/test_serve.py:430-462``: a bf16 deployment
    hot-swaps in an int8 model (the inherited knob is not applied to it)
    and the remembered bf16 knob survives for a later FusedMLP."""
    fa = port_fused(JFusedMLP.from_network(jax_net(11, (4, 8, 3))))
    fb = port_fused(JFusedMLP.from_network(jax_net(12, (4, 8, 3))))
    pred = Predictor(fa, buckets=(4,), dtype="bf16")
    x = pixels(3, 2, 4)
    pred.reload(QuantizedMLP.from_fused(fb))
    assert isinstance(pred.model, QuantizedMLP)
    assert pred.predict(x).shape == (2, 3)
    pred.reload(fb)
    assert pred.model.weights[0].dtype == torch.bfloat16
    pred.reload(fa, dtype=None)
    pred.reload(fb)
    assert pred.model.weights[0].dtype == torch.float32
    pred.reload(fa, dtype="bf16")
    pred.reload(fb)
    assert pred.model.weights[0].dtype == torch.bfloat16
    narrow = QuantizedMLP.from_fused(FusedMLP.from_numpy(
        [np.zeros((3, 5), np.float32)], [np.zeros(3, np.float32)],
        ["identity"], device="cpu"))
    with pytest.raises(ValueError, match="input width"):
        pred.reload(narrow)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [l for l in buf.getvalue().splitlines()
            if l and (l[0].isdigit() or l[0] == "-")]


def _rows(lines):
    return np.array([[float(v) for v in l.split(",")] for l in lines])


@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    """The flagship 784-300-100-10 as a feedforward checkpoint."""
    path = str(tmp_path_factory.mktemp("ck") / "flagship.npz")
    JC.save_network(path, jax_net(0, (784, 300, 100, 10)))
    return path


@pytest.mark.parametrize("probs", [False, True], ids=["classes", "probs"])
def test_cli_int8_matches_jax_cli(tmp_path, flagship_ckpt, probs):
    """Counterpart of ``tests/test_serve.py:110-150`` at the flagship's
    widths: ``--int8`` quantizes at load (w8a8) in both apps."""
    xfile = str(tmp_path / "batch.npy")
    np.save(xfile, pixels(4, 6, 784))
    common = [flagship_ckpt, "-i", xfile, "--buckets", "8", "--int8"]
    common += ["--probs"] if probs else []
    want = _cli(j_app.main, common)
    got = _cli(t_app.main, common + ["--device", "cpu"])
    assert len(got) == len(want) == 6
    if not probs:
        assert got == want
        return
    arrays, meta = TC.load_arrays(flagship_ckpt)
    tqm = t_app.load_model((arrays, meta), [300, 100], 784, 10, "logistic",
                           torch.device("cpu"), int8=True)
    assert isinstance(tqm, QuantizedMLP) and tqm.mode == "w8a8"
    np.testing.assert_allclose(_rows(got), _rows(want), rtol=0,
                               atol=code_step(tqm) + PRINT_ROUNDING)


def test_cli_int8_on_a_fused_checkpoint_and_bench(tmp_path):
    jfm = JFusedMLP.from_network(jax_net(5, (12, 8, 4)))
    path = str(tmp_path / "f.npz")
    JC.save_fused(path, jfm)
    xfile = str(tmp_path / "x.npy")
    np.save(xfile, pixels(6, 5, 12))
    argv = [path, "-i", xfile, "--in-dim", "12", "--out-dim", "4",
            "--buckets", "8", "--int8"]
    assert _cli(t_app.main, argv + ["--device", "cpu"]) == \
        _cli(j_app.main, argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_app.main([path, "--in-dim", "12", "--out-dim", "4", "--int8",
                    "--bench", "--buckets", "4,16", "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("Serving QuantizedMLP")
    assert json.loads(lines[-1])["latency"]["n"] == 10


def test_cli_serves_w8_checkpoint_in_its_mode(tmp_path):
    """A ``mode="w8"`` quantized_mlp checkpoint serves through the w8
    kernel, in both apps, with or without ``--int8``."""
    jqm = JQuantizedMLP.from_fused(
        JFusedMLP.from_network(jax_net(6, (12, 8, 4))), mode="w8")
    path = str(tmp_path / "w8.npz")
    JC.save_quantized(path, jqm)
    xfile = str(tmp_path / "x.npy")
    np.save(xfile, pixels(7, 5, 12))
    argv = [path, "-i", xfile, "--in-dim", "12", "--out-dim", "4",
            "--buckets", "8", "--probs"]
    want = _rows(_cli(j_app.main, argv))
    for extra in ([], ["--int8"]):
        got = _rows(_cli(t_app.main, argv + extra + ["--device", "cpu"]))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 + PRINT_ROUNDING)
    arrays, meta = TC.load_arrays(path)
    model = t_app.load_model((arrays, meta), [8], 12, 4, "logistic",
                             torch.device("cpu"))
    assert isinstance(model, QuantizedMLP) and model.mode == "w8"


def test_cli_bf16_rejects_quantized_checkpoint(tmp_path, capsys):
    """Counterpart of ``tests/test_serve.py:216-228``."""
    jqm = JQuantizedMLP.from_fused(JFusedMLP.from_network(jax_net(7)))
    path = str(tmp_path / "q.npz")
    JC.save_quantized(path, jqm)
    with pytest.raises(SystemExit):
        t_app.main([path, "--bf16", "--bench", "--buckets", "4",
                    "--in-dim", "10", "--out-dim", "4", "--device", "cpu"])
    assert "--bf16 does not apply" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        j_app.main([path, "--bf16", "--bench", "--buckets", "4"])


ENTRY_POINTS = [
    (TorchBackend.__init__, "device"),
    (FusedMLP.from_numpy, "device"),
    (QuantizedMLP.from_numpy, "device"),
    (TC.load_fused, "device"),
    (TC._fused_from_arrays, "device"),
    (TC.load_quantized, "device"),
    (TC._quantized_from_arrays, "device"),
]


@pytest.mark.parametrize("fn,arg", ENTRY_POINTS,
                         ids=[f.__qualname__ for f, _ in ENTRY_POINTS])
def test_entry_points_default_to_the_card(fn, arg):
    """Entry points run on the card unless the caller asks for the CPU, as
    the JAX package places arrays on its default accelerator."""
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_backend_default_device_is_cuda():
    assert TorchBackend().device == torch.device("cuda")
    assert TorchBackend(torch.float64, "cpu").device.type == "cpu"


def test_build_digest_covers_every_header(tmp_path):
    """An edited shared header changes the hash in every kernel library's
    name, so no stale library is loaded; an edited source changes only its
    own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert {"fused_linear_w8", "fused_linear_w8a8",
            "fused_mlp_w8a8_forward"} <= set(names)
    before = {n: cuda_build.source_digest(n, csrc) for n in names}
    assert before == {n: cuda_build.source_digest(n) for n in names}
    header = csrc / "int8_linear.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.source_digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "fused_linear_w8a8.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: cuda_build.source_digest(n, csrc) for n in names}
    assert [n for n in names if again[n] != after[n]] == ["fused_linear_w8a8"]
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert cuda_build.source_digest("fused_linear", csrc) != again[
        "fused_linear"]


def test_cpu_int8_serving_launches_no_kernel():
    K.reset_launch_counts()
    tqm = port_quantized(uniform_jax_quantized(74, ("relu", "identity")))
    for fused in (True, False):
        Predictor(tqm, buckets=(4,), use_fused_kernel=fused).predict(
            pixels(8, 3, 128))
    assert set(K.launch_counts().values()) == {0}
