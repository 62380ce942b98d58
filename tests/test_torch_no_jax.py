"""The port never imports JAX: every module imports, and the serving
(f32, int8 and recurrent), training, recurrent-sequence (``FusedRNN`` on
``fused_rnn_seq``), data-parallel, ``fit`` (with the NumPy oracle, the dots
app and the autoencoder) and ``fit_sequences`` paths (with ``adam8bit``,
EMA, accumulation and both examples' entry points), chained steps (host
and device shuffles, both loops), a ``mixed_precision`` bf16 step and a
2-rank CPU mesh ``fit`` (ZeRO-3, offload, EMA), a tensor-parallel ``fit``
on a ``(1, 2)`` mesh, ``shard_fused`` serving, the IR layer's
introspection, tensor helpers and gradient checkers, a ``(2,)`` GPipe step,
the dp step on a ``(2, 2)`` mesh, the dry run at 4 ranks and ``entry()``,
a ``PipelineMLP`` checkpoint, the staged-IR pipelines' gradients and
``fit`` on a ``(2,)`` stage mesh (GPipe and circular, ZeRO-1 on ``(2,
2)``), a hetero-tp gradient and ``fit`` on a ``(2, 2, 2)`` mesh, the
mesh planner, and the tooling (cost and memory analysis, ``profile_step``,
a ``fit(profile_dir=...)``, the NaN checks and a plan sweep's mechanics)
run end to end, in a fresh interpreter
where ``import jax`` fails; ``parallel/tp.py``, ``parallel/ir_pipeline.py``,
``parallel/pipeline.py``, ``ops/introspect.py``, ``tensor.py`` and
``testing.py`` import on their own there."""

import os
import re
import subprocess
import sys

import tensor_ops_tpu_torch
from torch_threads import one_torch_thread  # noqa: F401

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
    # the sequence route: FusedRNN's one fused_rnn_seq call, its plain loop
    # and plan here
    from tensor_ops_tpu_torch.ops import kernels as K
    ys, sf = m.seq_forward(np.ones((5, 3)))
    want, wsf = K.fused_rnn_seq(torch.ones(5, 1, 3), m.s0[None], m.wX, m.wS,
                                m.b)
    assert torch.equal(ys, want[:, 0]) and torch.equal(sf, wsf[0])
    assert K.rnn_seq_plan(1, 32, 512) == "resident"
    assert K.mlp_forward_plan(8, (784, 300, 100, 10)).tiles == 1

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
    mstep = PL.dp_megakernel_train_step(
        PL.make_mesh(4, shape=(2, 2), devices=["cpu"] * 4),
        ["logistic", "identity"], lr=0.1, axis="data")
    mloss, _, _ = mstep(xb, torch.eye(4)[[0, 1, 2, 3] * 2],
                        [torch.zeros(8, 12), torch.zeros(4, 8)],
                        [torch.zeros(8), torch.zeros(4)])
    assert float(mloss) > 0 and len(mstep.replicas) == 4
    # the dry run and entry()
    from tensor_ops_tpu_torch import dryrun
    assert len(dryrun.dryrun_multichip(4, ["cpu"] * 4)) == 15
    efn, eargs = dryrun.entry(device="cpu")
    assert tuple(efn(*eargs).shape) == (32, 10)

    mnist_data._fetch = offline
    mnist.main(["--epochs", "1", "--limit", "100", "-b", "100", "--minibatch",
                "50", "--fused", "-l", "8", "-c", "-d", d, "--device", "cpu"])
    mnist.main(["--epochs", "1", "--limit", "20", "-b", "20", "-l", "8", "-c",
                "-d", d, "--backend", "np"])

    # the fit slice: fit with adam through a checkpoint and a resume, the
    # NumPy oracle and its RNG, the dots app, the autoencoder
    from tensor_ops_tpu_torch.apps import dots
    from tensor_ops_tpu_torch.models import (Encoder, FusedAutoencoder,
                                             adam, cross_entropy, fit,
                                             squared_error)
    X = np.random.default_rng(0).uniform(size=(40, 12))
    Y = np.eye(4)[np.arange(40) % 4]
    fk = os.path.join(d, "f.npz")
    fit(net, cross_entropy(4), be, X, Y, epochs=1, batch_size=16,
        optimizer=adam(), checkpoint_path=fk, checkpoint_every=3,
        verbose=False)
    res = fit(net, cross_entropy(4), be, X, Y, epochs=2, batch_size=16,
              optimizer=adam(), checkpoint_path=fk, resume=True,
              verbose=False)
    assert res.steps == 6 and res.history[0]["step"] == 4
    nb = TT.NumpyBackend()
    onet = gen_net(nb, 12, 4, [(8, act_logistic())], act_softmax(), Rng(nb, 3))
    assert isinstance(onet.params[0], np.ndarray)
    assert fit(onet, cross_entropy(4), nb, X, Y, batch_size=20,
               verbose=False).steps == 2
    dots.main(["-s", "100", "np", "torch", "--device", "cpu"])
    enc = Encoder(gen_net(be, 12, 3, [], act_logistic(), Rng(be, 4)),
                  gen_net(be, 3, 12, [], act_logistic(), Rng(be, 5)))
    enc2, _ = enc.fit(squared_error(12), be, X, batch_size=20, verbose=False)
    fae = FusedAutoencoder.from_encoder(enc2)
    loss_ae, fae = fae.train(0.1, torch.as_tensor(X[:4], dtype=torch.float64))
    assert loss_ae > 0 and fae.n_enc == 1

    # the recurrent loop and the knobs: fit_sequences (adam8bit with
    # stochastic rounding, accumulation, EMA, a crash and a resume), fit
    # with EMA and accumulation, and both examples' entry points
    from tensor_ops_tpu_torch.models import (FitSeqResult, adam8bit,
                                             fit_sequences)
    from tensor_ops_tpu_torch.examples import production_fit, recurrent_sine
    XS = np.random.default_rng(1).uniform(size=(16, 4, 3))
    TS = np.random.default_rng(2).uniform(size=(16, 4, 2))
    rk2 = os.path.join(d, "rs.npz")
    kw = dict(batch_size=8, optimizer=adam8bit(stochastic_rounding=True),
              accum_steps=2, ema_decay=0.9, checkpoint_path=rk2,
              checkpoint_every=2, verbose=False)
    fit_sequences(rnet, squared_error(2), be32, XS, TS, epochs=1, **kw)
    sres = fit_sequences(rnet, squared_error(2), be32, XS, TS, epochs=2,
                         resume=True, **kw)
    assert isinstance(sres, FitSeqResult) and sres.steps == 4
    assert sres.history[0]["step"] == 3 and sres.ema_net is not None
    eres = fit(net, cross_entropy(4), be, X, Y, epochs=1, batch_size=16,
               accum_steps=2, ema_decay=0.5, verbose=False)
    assert eres.ema_net is not None
    assert production_fit.main(["--device", "cpu", "--workdir", d])[
        "acc"] > 0.9
    assert callable(recurrent_sine.main)  # runs in test_torch_examples

    # chained steps and mixed precision: a chained fit equals the unchained
    # one, the device shuffle and a chained fit_sequences run, a bf16 step
    # through the batched graph keeps f64 masters
    from tensor_ops_tpu_torch.models import chain, trainer
    from tensor_ops_tpu_torch.models.batched import batched_loss_graph
    one = fit(net, cross_entropy(4), be, X, Y, epochs=2, batch_size=8,
              optimizer=adam(), chain_steps=1, log_every=3, verbose=False)
    chained = fit(net, cross_entropy(4), be, X, Y, epochs=2, batch_size=8,
                  optimizer=adam(), chain_steps="auto", log_every=3,
                  verbose=False)
    assert all(torch.equal(a, b)
               for a, b in zip(one.net.params, chained.net.params))
    assert fit(net, cross_entropy(4), be, X, Y, epochs=1, batch_size=8,
               chain_shuffle="device", verbose=False).steps == 5
    assert fit_sequences(rnet, squared_error(2), be32, XS, TS, epochs=2,
                         batch_size=8, chain_steps=2,
                         verbose=False).steps == 4
    assert batched_loss_graph(net, cross_entropy(4), 8) is not None
    step = trainer.make_opt_step(net, cross_entropy(4), be, adam(),
                                 mixed_precision=True)
    v, _, ps = step(0.01, be.asarray(X[:8]), be.asarray(Y[:8]),
                    adam().init(net.params), net.params)
    assert float(v) > 0 and all(p.dtype == torch.float64 for p in ps)
    assert chain.chain_counts()["captures"] == 0  # no card here
assert sys.modules["jax"] is None
assert not any(m.startswith("jax.") or m == "jaxlib" for m in sys.modules)
# the mesh's data axis: a 2-rank CPU mesh fit at ZeRO-3 with offload and
# EMA
from tensor_ops_tpu_torch.parallel import mesh as pmesh
from tensor_ops_tpu_torch.models import adam, cross_entropy, fit
m2 = pmesh.make_mesh(2, shape=(2, 1), devices=["cpu"] * 2)
rx = np.random.default_rng(0)
Xm, Ym = rx.uniform(size=(16, 12)), np.eye(4)[rx.integers(0, 4, 16)]
rm = fit(gen_net(be, 12, 4, [(8, act_logistic())], act_softmax(), Rng(be, 0)),
         cross_entropy(4), be, Xm, Ym, batch_size=8, optimizer=adam(),
         mesh=m2, zero_stage=3, offload_opt_state=True, ema_decay=0.9,
         verbose=False)
assert rm.steps == 2 and all(np.isfinite(h["loss"]) for h in rm.history)
# the model axis: the executor and the segment matching import on their
# own; fit on a (1, 2) CPU mesh trains through the executor, and a sharded
# FusedMLP serves through the Predictor's mesh route
import tensor_ops_tpu_torch.parallel.ir_pipeline as pip
import tensor_ops_tpu_torch.parallel.tp as ptp
net2m = gen_net(be, 12, 4, [(8, act_logistic())], act_softmax(), Rng(be, 0))
assert [s.kind for s in ptp.plan(net2m, pmesh.param_specs(
    net2m.param_stack, pmesh.make_mesh(2, devices=["cpu"] * 2)), 2)] == [
    "row", "col"]
assert len(pip.network_segments(net2m)) == 2
m12 = pmesh.make_mesh(2, devices=["cpu"] * 2)
rt = fit(net2m, cross_entropy(4), be, Xm, Ym, batch_size=8, optimizer=adam(),
         mesh=m12, clip_norm=1.0, verbose=False)
assert rt.net.params[0].spec == ("model", None) and rt.steps == 2
sp = Predictor(pmesh.shard_fused(FusedMLP.from_network(net2m), m12),
               buckets=(4,))
assert sp._sharded and sp.predict(Xm[:3]).shape == (3, 4)
# the rest of the IR layer and the pipelines: introspection, the tensor
# helpers, the gradient checkers, a (2,) GPipe step and a PipelineMLP's
# save and load
import tensor_ops_tpu_torch.ops.introspect as intro
import tensor_ops_tpu_torch.parallel.pipeline as pipe
import tensor_ops_tpu_torch.tensor as tens
import tensor_ops_tpu_torch.testing as testing
from tensor_ops_tpu_torch.utils.checkpoint import load_pipeline, save_pipeline
assert intro.graph_stats(net.op)["nodes"] == intro.describe(net.op).count(
    "\n") + 1
assert tens.arg_max(be, tens.one_hot(be, 1.0, 0.0, 2, 4)) == 2
testing.check_grads_vs_autograd(TT.prim.duplicate((3,)) >> TT.prim.dot(3),
                                be, (np.ones(3),))
pm = pipe.make_pipeline_mesh(2, devices=["cpu"] * 2)
pmodel = pipe.shard_pipeline_model(pipe.PipelineMLP.init(
    4, 8, 2, 2, 1, torch.Generator().manual_seed(0), device="cpu"), pm)
xp = torch.rand(8, 4, generator=torch.Generator().manual_seed(1))
yp = torch.eye(2)[torch.arange(8) % 2]
lp, newp = pipe.pipeline_train_step(pmodel, pm, 2)(0.5, xp, yp,
                                                   *pmodel.params())
assert np.isfinite(float(lp)) and newp[2].spec[0] == "stage"
with tempfile.TemporaryDirectory() as d:
    ck = os.path.join(d, "pipe.npz")
    save_pipeline(ck, pmodel.replace_params(newp))
    back = load_pipeline(ck, device="cpu")
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(back.params(), newp))
# the staged-IR pipelines: the gradients of a heterogeneous partition, and
# fit's pipeline mode (GPipe, circular, dp x pp with ZeRO-1)
import tensor_ops_tpu_torch.parallel.ir_pipeline as irp
netp = gen_net(be, 12, 4, [(8, act_logistic())] * 3, act_softmax(),
               Rng(be, 0))
vg, gg = irp.ir_pipeline_grads(netp, cross_entropy(4), be, pm, 2)(
    Xm, Ym, *irp.partition_network(netp, 2).flat_params())
assert np.isfinite(float(vg)) and gg[2].spec[0] == "stage"
for kw in (dict(mesh=pm), dict(mesh=pm, pipeline_schedule="circular"),
           dict(mesh=pipe.make_dp_pipeline_mesh(2, 2, devices=["cpu"] * 4),
                shard_opt_state=True)):
    rp = fit(netp, cross_entropy(4), be, Xm, Ym, batch_size=8,
             optimizer=adam(), verbose=False, **kw)
    assert rp.steps == 2 and len(rp.net.params) == len(netp.params)
assert "balance" in irp.describe_partition(irp.partition_network(netp, 3))
# the tensor-parallel pipelines: a hetero-tp gradient and fit on (2, 2, 2)
m3 = pipe.make_3d_pipeline_mesh(2, 2, 2, devices=["cpu"] * 8)
pyr = gen_net(be, 16, 16, [(8, act_logistic()), (4, act_logistic())],
              act_logistic(), Rng(be, 1))
ptp = irp.partition_network(pyr, 2, m3)
assert type(ptp).__name__ == "HeteroTpPipelinedNetwork"
Xp = np.random.default_rng(2).uniform(size=(8, 16))
vt, gt = irp.ir_pipeline_grads(pyr, squared_error(16), be, m3, 2)(
    Xp, Xp, *ptp.flat_params())
assert np.isfinite(float(vt)) and gt[0].spec == ("stage", "model", None)
r3 = fit(netp, cross_entropy(4), be, np.concatenate([Xm] * 4),
         np.concatenate([Ym] * 4), batch_size=16, optimizer=adam(),
         verbose=False, mesh=m3, pipeline_microbatches=2)
assert r3.steps == 4 and len(r3.net.params) == len(netp.params)
from tensor_ops_tpu_torch.parallel import describe_plans, plan_meshes
assert "(2,2,2)" in describe_plans(plan_meshes(pyr, 8, 64), top=20)
# the tooling: profiling, a traced fit, the NaN checks and the autotuner's
# mechanics on the CPU (an injected timer; a cache in a temporary file)
from tensor_ops_tpu_torch.utils import profiling as prof
from tensor_ops_tpu_torch.ops import autotune as tune
from tensor_ops_tpu_torch.ops import kernels as K
wc = torch.ones(16, 16)
assert prof.cost_analysis(lambda c: torch.tanh(c @ wc), wc)["flops"] == 8192
assert prof.memory_analysis(lambda c: c @ wc, wc)["output_size_in_bytes"] \
    == 1024
assert prof.profile_step(lambda c: c @ wc * 0.5, wc, steps=(2, 4),
                         reps=1)["flops"] == 8192
with tempfile.TemporaryDirectory() as d:
    rp = fit(net, cross_entropy(4), be, X, Y, epochs=2, batch_size=8,
             profile_dir=os.path.join(d, "t"), verbose=False)
    assert rp.steps == 10 and os.listdir(os.path.join(d, "t"))
    with prof.device_trace(os.path.join(d, "u")):
        pass
    prof.enable_nan_checks(True)
    try:
        torch.log(-torch.ones(1))
        raise AssertionError("the NaN checks let a NaN through")
    except FloatingPointError:
        pass
    finally:
        prof.enable_nan_checks(False)
    cache = tune.TileCache(os.path.join(d, "plans.json"))
    cands = K.linear_candidates(8, 784, 300)
    best = tune.sweep("linear", (8, 784, 300, torch.float32), cands,
                      lambda p: p, timer=lambda call: [float(call().split)],
                      cache=cache, dev="NVIDIA H100 80GB HBM3")
    assert best.split == 1 and tune.TileCache(cache.path).get(tune.make_key(
        "linear", dev="NVIDIA H100 80GB HBM3", B=8, K=784, O=300,
        dtype="float32"))["candidates"] == len(cands)
assert sys.modules["jax"] is None
print("NAMES", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("NAMES")[-1])
    assert n >= 40  # the package walk reaches every module, examples too


def test_two_processes_run_without_jax(tmp_path):
    """``init_distributed`` and kernel 9's phases over the ranks of two
    processes (``tests/torch_mp_worker.py``'s ``coll`` scenario) in two
    interpreters where ``import jax`` fails."""
    from test_torch_multihost import launch

    runs = launch(tmp_path, "coll", prelude='import sys; '
                  'sys.modules["jax"] = None; ')
    assert [r["info"]["process_count"] for r in runs] == [2, 2]
    assert all(len(r["coll"]["ar"]) == 4 for r in runs)


def test_no_jax_import_in_sources():
    """Neither JAX nor the JAX package is imported anywhere in the port
    (nor by the smoke script and the port's tools), not even lazily inside a
    function."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|tensor_ops_tpu)(?!_torch)\b", re.M)
    pkg = tensor_ops_tpu_torch.__path__[0]
    tools = os.path.join(ROOT, "tools")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(tools, f) for f in sorted(os.listdir(tools))
        if f.endswith(".py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as fh:
            if pattern.search(fh.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert len(files) > 15 and offenders == []
