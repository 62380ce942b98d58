"""The port never imports JAX: every module imports, and the serving
(f32, int8 and recurrent), training and data-parallel paths run end to end,
in a fresh interpreter where ``import jax`` fails."""

import os
import re
import subprocess
import sys

import tensor_ops_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
import tensor_ops_tpu_torch as TT

names = [m.name for m in pkgutil.walk_packages(TT.__path__, "tensor_ops_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (FusedMLP, Predictor, act_logistic,
                                         act_softmax, gen_net)
from tensor_ops_tpu_torch.ops import ir
from tensor_ops_tpu_torch.utils.checkpoint import load_network, save_network
from tensor_ops_tpu_torch.apps import mnist, serve
from tensor_ops_tpu_torch.utils import mnist_data

be = TT.TorchBackend(torch.float64, "cpu")
net = gen_net(be, 12, 4, [(8, act_logistic())], act_softmax(), Rng(be, 0))
x = be.asarray(np.linspace(0, 1, 12))
p = net.run(be, x)
assert abs(float(p.sum()) - 1) < 1e-12
v, g = ir.value_and_grad(net.op >> TT.prim.sum_rows((4,)), be,
                         (x,) + net.params)
assert len(g) == 1 + len(net.params)
with tempfile.TemporaryDirectory() as d:
    ck = os.path.join(d, "n.npz")
    save_network(ck, net)
    net2 = load_network(ck, net, be)
    pred = Predictor(FusedMLP.from_network(net2), buckets=(4,))
    out = pred.predict(np.random.default_rng(0).uniform(size=(3, 12)))
    assert out.shape == (3, 4)
    xf = os.path.join(d, "x.npy")
    np.save(xf, np.zeros((2, 12), np.float32))
    serve.main([ck, "-l", "8", "--in-dim", "12", "--out-dim", "4", "-i", xf,
                "--device", "cpu"])
    # int8 serving: --int8 quantizes at load (w8a8), a saved w8 model
    # serves in its mode, a uniform stack runs the whole-MLP route
    serve.main([ck, "-l", "8", "--in-dim", "12", "--out-dim", "4", "-i", xf,
                "--int8", "--device", "cpu"])
    from tensor_ops_tpu_torch.models import QuantizedMLP
    from tensor_ops_tpu_torch.utils.checkpoint import save_quantized
    qk = os.path.join(d, "q.npz")
    save_quantized(qk, QuantizedMLP.from_fused(FusedMLP.from_network(net2),
                                               mode="w8"))
    serve.main([qk, "--in-dim", "12", "--out-dim", "4", "-i", xf, "--probs",
                "--device", "cpu"])
    wide = FusedMLP.from_numpy([np.eye(128, dtype=np.float32)] * 2,
                               [np.zeros(128, np.float32)] * 2,
                               ["relu", "identity"], device="cpu")
    qp = Predictor(QuantizedMLP.from_fused(wide), buckets=(4,))
    assert qp._serving[2] and qp.predict(np.ones((3, 128))).shape == (3, 128)
    # training: the whole-step route and a Network predictor
    _, fm = FusedMLP.from_network(net2).train_fullfused(
        0.5, be.asarray(np.eye(12)[:4]), be.asarray(np.eye(4)))
    assert all(torch.isfinite(w).all() for w in fm.weights)
    assert Predictor(net2, be, buckets=(4,)).predict(np.zeros(12)).shape == (4,)

    def offline(url, timeout=20.0):
        raise OSError("offline")

    # recurrent serving from the stored arch, and FusedRNN on the kernel
    # route's plain version
    from tensor_ops_tpu_torch.models import FusedRNN
    from tensor_ops_tpu_torch.models import recurrent as R
    from tensor_ops_tpu_torch.utils.checkpoint import save_recurrent
    be32 = TT.TorchBackend(torch.float32, "cpu")
    rnet = R.gen_net(be32, 3, 2, [(6, act_logistic(), act_logistic())],
                     act_logistic(), None, Rng(be32, 1))
    rk = os.path.join(d, "r.npz")
    save_recurrent(rk, rnet)
    sf = os.path.join(d, "s.npy")
    np.save(sf, np.zeros((2, 5, 3), np.float32))
    serve.main([rk, "-i", sf, "--probs", "--buckets", "2", "--device", "cpu"])
    cell = R.fully_connected(act_logistic(), be32, 3, 4, Rng(be32, 2))
    m = FusedRNN.from_recurrent(cell)
    m = FusedRNN(m.wX, m.wS, m.b, m.s0, impl="pallas")
    v, m = m.train(0.01, 0.01, np.ones((5, 3)), np.zeros((5, 4)))
    assert m.impl == "pallas" and v > 0

    # the data-parallel slice: each ring wrapper, then one dp step on CPU
    # ranks
    from tensor_ops_tpu_torch import parallel as PL
    xs = [torch.full((4, 3), float(r)) for r in range(4)]
    for ring in (PL.ring_all_reduce, PL.ring_all_reduce_bidir):
        assert all(torch.equal(s, torch.full((4, 3), 6.0)) for s in ring(xs))
    rs = PL.ring_reduce_scatter(xs)
    assert torch.equal(PL.ring_all_gather(rs)[0], torch.full((4, 3), 6.0))
    group = PL.RankGroup(devices=["cpu"] * 4)
    step = PL.dp_megakernel_train_step(group, ["logistic", "identity"], lr=0.1)
    xb = torch.rand(8, 12, generator=torch.Generator().manual_seed(0))
    loss, dws, dbs = step(xb, torch.eye(4)[[0, 1, 2, 3] * 2],
                          [torch.zeros(8, 12), torch.zeros(4, 8)],
                          [torch.zeros(8), torch.zeros(4)])
    assert float(loss) > 0 and len(step.replicas) == 4

    mnist_data._fetch = offline
    mnist.main(["--epochs", "1", "--limit", "100", "-b", "100", "--minibatch",
                "50", "--fused", "-l", "8", "-c", "-d", d, "--device", "cpu"])
assert sys.modules["jax"] is None
assert not any(m.startswith("jax.") or m == "jaxlib" for m in sys.modules)
print("NAMES", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("NAMES")[-1])
    assert n >= 15


def test_no_jax_import_in_sources():
    """Neither JAX nor the JAX package is imported anywhere in the port
    (nor by the smoke script), not even lazily inside a function."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|tensor_ops_tpu)(?!_torch)\b", re.M)
    pkg = tensor_ops_tpu_torch.__path__[0]
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as fh:
            if pattern.search(fh.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert len(files) > 15 and offenders == []
