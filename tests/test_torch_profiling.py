"""The port's tooling (``tensor_ops_tpu_torch/utils/profiling.py`` and
``fit(profile_dir=...)``) against the JAX package's: the ports of
``tests/test_utils.py``'s profiling tests and ``tests/test_production_
knobs.py``'s trace tests, ``cost_analysis`` and ``memory_analysis`` held to
XLA's counts on the same inputs, ``fit(profile_dir=...)`` held to the JAX
``fit`` at 1e-9 in f64 and bit-equal to its own untraced unchained run, and
the hand kernels' wrappers reporting their plain version's work."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import adam as j_adam
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.utils import profiling as JP
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import Network, act_logistic, act_softmax
from tensor_ops_tpu_torch.models import adam, cross_entropy, fit, gen_net
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.utils.profiling import (cost_analysis,
                                                  device_trace,
                                                  enable_nan_checks,
                                                  measure_loop,
                                                  memory_analysis,
                                                  nan_checks_enabled,
                                                  profile_step)
from torch_threads import one_torch_thread  # noqa: F401

TB = TorchBackend(torch.float64, "cpu")
JB = T.JaxBackend(dtype=jnp.float64)


@pytest.fixture
def nan_checks():
    """The NaN checks on for one test, off after it whatever happens."""
    enable_nan_checks(True)
    yield
    enable_nan_checks(False)


def _cw(lib):
    r = np.random.default_rng(0)
    c = r.normal(size=(8, 64)).astype(np.float32)
    w = r.normal(size=(64, 64)).astype(np.float32)
    b = r.normal(size=(64,)).astype(np.float32)
    return lib(c), lib(w), lib(b)


def _trace_files(d):
    return glob.glob(os.path.join(str(d), "**", "*.pt.trace.json"),
                     recursive=True)


def test_device_trace_writes_profile(tmp_path):
    """``tests/test_utils.py:115``: a trace around an IR run writes a file,
    one that TensorBoard and Perfetto read (JSON trace events)."""
    from tensor_ops_tpu_torch import prim as P
    from tensor_ops_tpu_torch.ops import ir

    with device_trace(str(tmp_path)):
        x = TB.asarray(np.ones((8, 8)))
        ir.run(P.mat_mat(8, 8, 8), TB, (x, x))
    files = _trace_files(tmp_path)
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # a second trace opens once the first is closed
    with device_trace(str(tmp_path / "again")):
        pass
    assert len(_trace_files(tmp_path / "again")) == 1


def test_enable_nan_checks_roundtrip(nan_checks):
    """``tests/test_utils.py:143``: the getter reads the switch back; while
    it is on, the first op whose output holds a NaN raises naming the op,
    in the forward and in autograd's backward; off, neither raises."""
    assert nan_checks_enabled()
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(torch.tensor([-1.0, 2.0]))
    # the forward is finite; the NaN first appears in the backward (0 * inf)
    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    y = (torch.sqrt(x) * 0).sum()
    assert float(y.detach()) == 0.0
    with pytest.raises(FloatingPointError, match="nan"):
        y.backward()
    # infinities are not NaN (as in jax_debug_nans)
    assert torch.isinf(torch.tensor([1.0]) / 0).all()
    enable_nan_checks(False)
    assert not nan_checks_enabled()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    (torch.sqrt(x) * 0).sum().backward()
    assert torch.isnan(x.grad).all()


def test_nan_checks_through_the_kernels(nan_checks):
    """On the CPU a wrapper runs its plain version, whose ops the check
    sees; a kernel's own outputs (what a launch through ctypes gives on the
    card) are checked by its wrapper, which names the kernel."""
    x = torch.ones(4, 3)
    x[1, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="nan"):
        K.fused_linear(x, torch.ones(2, 3), torch.zeros(2))
    y = torch.ones(4, 2)
    y[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="fused_linear"):
        K._watched("fused_linear", lambda: (y, None))
    K._watched("fused_linear", lambda: (torch.ones(4, 2), None))
    enable_nan_checks(False)
    K._watched("fused_linear", lambda: (y, None))


def test_nan_checks_run_fit_unchained(nan_checks):
    """A captured step cannot synchronise to check its ops: under the checks
    ``chain_steps="auto"`` runs unchained (bit-equal to ``chain_steps=1``)
    and an int ``chain_steps > 1`` raises naming the checks."""
    X, Y = _task(32)
    net = _net()
    auto = fit(net, cross_entropy(2), TB, X, Y, epochs=2, batch_size=16,
               verbose=False)
    one = fit(net, cross_entropy(2), TB, X, Y, epochs=2, batch_size=16,
              chain_steps=1, verbose=False)
    assert all(torch.equal(a, b) for a, b in zip(auto.net.params,
                                                 one.net.params))
    with pytest.raises(ValueError, match="enable_nan_checks"):
        fit(net, cross_entropy(2), TB, X, Y, epochs=1, batch_size=16,
            chain_steps=4, verbose=False)


def test_profile_step_reports_rates():
    """``tests/test_utils.py:208``: the keys and rates; the differential is
    retried with wider step gaps when the host makes it negative."""
    w = torch.ones(64, 64)

    def step(c):
        return torch.tanh(c @ w)

    init = torch.ones(8, 64)
    for steps in ((20, 200), (50, 1000), (50, 2000), (100, 4000)):
        stats = profile_step(step, init, steps=steps, reps=5)
        if stats["per_step_s"] > 0:
            break
    assert stats["per_step_s"] > 0 and stats["steps_per_s"] > 0
    assert stats["compile_s"] >= 0
    assert stats["flops"] == 2 * 8 * 64 * 64
    assert stats["bytes_accessed"] > 0
    assert stats["tflops_per_s"] > 0 and stats["gbytes_per_s"] > 0
    loop = measure_loop(step, init, steps=steps, reps=3)
    assert set(loop) == {"per_step_s", "steps_per_s"}


def test_memory_analysis_reports_bytes():
    """``tests/test_utils.py:367``."""
    w = torch.ones(64, 64)
    x = torch.ones(8, 64)
    ma = memory_analysis(lambda x: torch.tanh(x @ w), x)
    assert ma["argument_size_in_bytes"] >= 8 * 64 * 4
    assert ma["output_size_in_bytes"] >= 8 * 64 * 4
    assert ma["total_in_bytes"] > 0
    # the product's result is the one temporary; an output that is its
    # argument aliases it
    assert ma["temp_size_in_bytes"] == 8 * 64 * 4
    same = memory_analysis(lambda x: x, x)
    assert same["alias_size_in_bytes"] == 8 * 64 * 4
    assert same["total_in_bytes"] == 8 * 64 * 4


@pytest.mark.parametrize("name,fn", [
    ("c @ w", lambda c, w, b, t: c @ w),
    ("tanh(c @ w)", lambda c, w, b, t: t(c @ w)),
])
def test_cost_analysis_counts_as_xla_does(name, fn):
    """``cost_analysis``' flops and transcendentals equal XLA's on the same
    inputs (65,536 flops, 512 transcendentals for the tanh)."""
    jc, jw, jb = _cw(jnp.asarray)
    want = JP.cost_analysis(lambda c: fn(c, jw, jb, jnp.tanh), jc)
    tc, tw, tb = _cw(torch.tensor)
    got = cost_analysis(lambda c: fn(c, tw, tb, torch.tanh), tc)
    assert got["flops"] == want["flops"] == 65536
    assert got["transcendentals"] == want.get("transcendentals", 0.0)
    assert got["bytes accessed"] > 0


def test_cost_analysis_counts_products_only():
    """XLA also counts one flop per element of elementwise arithmetic
    (66,048 for ``tanh(c @ w + b)``); the port counts the products."""
    jc, jw, jb = _cw(jnp.asarray)
    want = JP.cost_analysis(lambda c: jnp.tanh(c @ jw + jb), jc)
    tc, tw, tb = _cw(torch.tensor)
    got = cost_analysis(lambda c: torch.tanh(c @ tw + tb), tc)
    assert want["flops"] == 66048 and got["flops"] == 65536
    assert got["transcendentals"] == want["transcendentals"] == 512


def test_memory_analysis_argument_and_output_bytes_as_xla():
    jc, jw, _ = _cw(jnp.asarray)
    want = JP.memory_analysis(lambda c: jnp.tanh(c @ jw), jc)
    tc, tw, _ = _cw(torch.tensor)
    got = memory_analysis(lambda c: torch.tanh(c @ tw), tc)
    for k in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert got[k] == want[k], k
    assert "generated_code_size_in_bytes" not in got


def test_kernels_count_the_work_of_their_plain_math():
    """A wrapper on the card reports its plain version's math, run on meta
    tensors of the same shapes, in place of its own allocations and copies
    (``kernels._watched``): ``fused_linear`` and the whole step count what
    their plain versions count, the step its 2·B·i·o a product of the
    forward, of each weight gradient and of each input gradient past the
    first layer."""
    r = np.random.default_rng(3)
    dims = (12, 8, 4)
    x = torch.tensor(r.uniform(size=(5, 12)), dtype=torch.float32)
    y = torch.eye(4)[torch.arange(5) % 4]
    ws = [torch.tensor(r.normal(size=(dims[k + 1], dims[k])),
                       dtype=torch.float32) for k in range(2)]
    bs = [torch.zeros(d) for d in dims[1:]]
    acts = ["logistic", "identity"]

    def bookkeeping():
        """What a wrapper does around its launch: allocate, copy."""
        out = torch.empty(5, 8)
        x.contiguous().float().clone()
        return out, None

    plain = cost_analysis(lambda: K.fused_linear_ref(x, ws[0], bs[0],
                                                     "logistic", True))
    launched = cost_analysis(lambda: K._watched(
        "fused_linear", bookkeeping, K.fused_linear_ref,
        (x, ws[0], bs[0], "logistic", True)))
    assert launched == plain and plain["flops"] == 2 * 5 * 12 * 8
    assert plain["transcendentals"] == 5 * 8
    via_wrapper = cost_analysis(lambda: K.fused_linear(x, ws[0], bs[0],
                                                       "logistic"))
    assert via_wrapper["flops"] == plain["flops"]

    step_plain = cost_analysis(lambda: K.fused_mlp_train_step(
        x, y, ws, bs, 0.1, acts))
    step_launched = cost_analysis(lambda: K._watched(
        "fused_mlp_train_step", bookkeeping, K.fused_mlp_train_step_ref,
        (x, y, ws, bs, 0.1, acts)))
    assert step_launched == step_plain
    assert step_plain["flops"] == 2 * 5 * (12 * 8 + 8 * 4) * 2 + 2 * 5 * 8 * 4
    # a collective reports its bytes
    moved = cost_analysis(lambda: K._watched("ring_all_reduce", lambda: [x],
                                             cost=(0, 0, 480)))
    assert moved == {"flops": 0.0, "transcendentals": 0.0,
                     "bytes accessed": 480.0}


# --- fit(profile_dir=...) --------------------------------------------------

def _task(n):
    r = np.random.default_rng(11)
    X = r.uniform(-1, 1, size=(n, 4))
    return X, np.eye(2)[(X[:, 0] > 0).astype(int)]


def _jnet(seed=13):
    return j_gen_net(JB, 4, 2, [(6, j_logistic())], j_softmax(),
                     JRng(JB, seed=seed))


def _net(params=None):
    tmpl = gen_net(TB, 4, 2, [(6, act_logistic())], act_softmax(),
                   Rng(TB, 0))
    if params is None:
        return tmpl
    return Network(tmpl.op, tuple(TB.asarray(np.asarray(p)) for p in params),
                   tmpl.act_names)


def test_profile_dir_captures_trace(tmp_path):
    """``tests/test_production_knobs.py:255``: the trace of steps 2-5 is
    written and training proceeds; a run shorter than the window stops
    cleanly, and a later ``device_trace`` opens."""
    X, Y = _task(64)
    pd = str(tmp_path / "trace")
    res = fit(_net(), cross_entropy(2), TB, X, Y, epochs=2, batch_size=32,
              lr=0.05, optimizer=adam(), profile_dir=pd, verbose=False,
              prefetch=0, log_every=1)
    assert res.steps == 4
    assert len(_trace_files(pd)) == 1
    pd2 = str(tmp_path / "trace2")
    res2 = fit(_net(), cross_entropy(2), TB, X, Y, epochs=1, batch_size=64,
               lr=0.05, profile_dir=pd2, verbose=False, prefetch=0,
               log_every=1)
    assert res2.steps == 1
    with device_trace(str(tmp_path / "trace3")):
        pass
    # a run of 3 steps stops its trace in the loop's finally
    pd4 = str(tmp_path / "trace4")
    res4 = fit(_net(), cross_entropy(2), TB, X[:48], Y[:48], epochs=1,
               batch_size=16, lr=0.05, profile_dir=pd4, verbose=False,
               prefetch=0, log_every=1)
    assert res4.steps == 3 and len(_trace_files(pd4)) == 1
    with device_trace(str(tmp_path / "trace5")):
        pass


def test_profile_dir_rejects_numpy_backend(tmp_path):
    """``tests/test_production_knobs.py:332``: the NumPy oracle has nothing
    to trace."""
    X, Y = _task(8)
    nb = NumpyBackend()
    net = gen_net(nb, 4, 2, [(6, act_logistic())], act_softmax(), Rng(nb, 1))
    with pytest.raises(ValueError, match="profile_dir"):
        fit(net, cross_entropy(2), nb, X, Y, epochs=1, batch_size=8,
            lr=0.05, profile_dir=str(tmp_path / "t"), verbose=False)
    assert not os.path.exists(tmp_path / "t")


def test_profile_dir_fit_matches_jax_and_its_unchained_run(tmp_path):
    """``fit(profile_dir=...)`` against the JAX ``fit`` with the same
    arguments (1e-9 in f64) and bit-equal to the port's run with
    ``chain_steps=1`` and no trace."""
    X, Y = _task(96)
    jn = _jnet()
    kw = dict(epochs=2, batch_size=16, lr=0.05, seed=3, log_every=2,
              verbose=False, prefetch=0)
    j = j_fit(jn, j_xent(2), JB, X, Y, optimizer=j_adam(),
              profile_dir=str(tmp_path / "jax"), **kw)
    t = fit(_net(jn.params), cross_entropy(2), TB, X, Y, optimizer=adam(),
            profile_dir=str(tmp_path / "torch"), **kw)
    u = fit(_net(jn.params), cross_entropy(2), TB, X, Y, optimizer=adam(),
            chain_steps=1, **kw)
    assert t.steps == j.steps == u.steps == 12
    assert [h["step"] for h in t.history] == [h["step"] for h in j.history]
    for a, b in zip(t.history, j.history):
        assert abs(a["loss"] - b["loss"]) <= 1e-9
    for a, b in zip(t.net.params, j.net.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    assert [h["loss"] for h in t.history] == [h["loss"] for h in u.history]
    assert all(torch.equal(a, b) for a, b in zip(t.net.params, u.net.params))
    assert len(_trace_files(tmp_path / "torch")) == 1
