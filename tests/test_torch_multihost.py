"""The port in several processes, on the CPU: two processes of 4 CPU ranks
each (``tests/torch_mp_worker.py``), wired by ``init_distributed``, run the
four scenarios of ``tests/test_multihost.py`` through the production
``fit`` / ``fit_sequences`` path (each process's loader shard, a checkpoint
written by process 0 mid-run and an exact resume) and kernel 9's phases
over ranks of both processes.

Each scenario is held three ways: both processes report the same losses
and leaves; the run is bit-equal to the port's one-process run on the same
8-rank mesh (the same loader shards concatenated, uninterrupted); and it is
within 1e-9 in f64 of the JAX package's semantics, taken from one JAX
device where the JAX tests hold it equal to their mesh (the same shard
loaders concatenated and the unsharded step, or the same mesh-less call).
The entry points below ``fit`` (the pipelines' steps and forwards, the
staged-IR loss and gradients, ``sharded_train_step`` / ``sharded_forward``)
and the collectives over two processes are bit-equal to one process's.

Also here: the ports of ``tests/test_parallel.py``'s distributed cases
(the single-process no-op, the environment's resolution against a patched
``torch.distributed.init_process_group``, the dry run) and of
``tests/test_multihost.py``'s alignment check.  Each worker has a hard
limit of 120 s; the two run at once, about 15 s."""

import json
import os
import re
import socket
import subprocess
import sys
from types import SimpleNamespace

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
from tensor_ops_tpu.models import fit_sequences as j_fit_sequences
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.models import Network as JNetwork
from tensor_ops_tpu.models.recurrent import RecurrentNetwork as JRecurrent
from tensor_ops_tpu.models.recurrent import gen_net as j_gen_rnet
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.models.trainer import make_opt_step as j_make_opt_step
from tensor_ops_tpu.utils.native import NativeLoader as JLoader
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (Network, act_logistic, act_softmax,
                                         cross_entropy, fit_sequences,
                                         gen_net, optim, squared_error)
from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork
from tensor_ops_tpu_torch.models.recurrent import gen_net as gen_rnet
from tensor_ops_tpu_torch.models.trainer import (
    _check_process_data_alignment, _like, _mesh_setup, _scalars, fit,
    make_opt_step)
from tensor_ops_tpu_torch.parallel import collective_kernels as K
from tensor_ops_tpu_torch.parallel import distributed as D
from tensor_ops_tpu_torch.parallel import ir_pipeline as IP
from tensor_ops_tpu_torch.parallel import Mesh as TMesh
from tensor_ops_tpu_torch.parallel import (make_dp_pipeline_mesh, make_mesh,
                                           make_pipeline_mesh, param_specs)
from tensor_ops_tpu_torch.utils.native import NativeLoader
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mp_worker.py")
ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
NB = NumpyBackend()
TB = TorchBackend(torch.float64, "cpu")
CPU8 = ["cpu"] * 8

r0 = np.random.default_rng(0)
X = r0.uniform(0, 1, size=(64, 12))
Y = np.eye(4)[r0.integers(0, 4, size=64)]
r2 = np.random.default_rng(7)
X2 = r2.uniform(0, 1, size=(64, 8))
Y2 = r2.uniform(0, 1, size=(64, 8))
t4 = np.linspace(0, 1, 7)
WAVES = np.sin(2 * np.pi * t4[None, :]
               + np.random.default_rng(11).uniform(0, np.pi, size=(64, 1)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(tmp, scenarios: str, prelude: str = "", procs: int = 2,
           timeout: float = 120.0, local: int = 4) -> list:
    """Run ``procs`` workers (``local`` CPU ranks each) on ``scenarios``;
    returns each process's JSON.  ``prelude`` runs before the worker
    (``python -c``), e.g. to block ``import jax``."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update({"TOPS_COORDINATOR": f"localhost:{port}",
                "TOPS_NUM_PROCESSES": str(procs),
                "TOPS_LOCAL_DEVICES": ",".join(["cpu"] * local),
                "TOPS_MP_CKPT": str(tmp / "mp_ck.npz"),
                "TOPS_MP_SCENARIOS": scenarios,
                "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")})
    code = (prelude + "import runpy; runpy.run_path("
            f"{WORKER!r}, run_name='__main__')")
    ps = []
    for rank in range(procs):
        env_r = dict(env, TOPS_PROCESS_ID=str(rank),
                     TOPS_MP_OUT=str(tmp / f"rank{rank}.json"))
        ps.append(subprocess.Popen([sys.executable, "-c", code], env=env_r,
                                   cwd=ROOT, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in ps:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(ps, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    return [json.load(open(tmp / f"rank{k}.json")) for k in range(procs)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("mp"),
                  "zero3,pp,ring,seq,api,coll")


# ---------------------------------------------------------------------------
# The one-process runs: the port's and the JAX package's
# ---------------------------------------------------------------------------


def torch_net(widths, out_act, seed):
    host = gen_net(NB, widths[0], widths[-1],
                   [(h, act_logistic()) for h in widths[1:-1]], out_act,
                   Rng(NB, seed=seed))
    return Network(host.op, tuple(TB.asarray(np.asarray(p))
                                  for p in host.params), host.act_names)


def jax_net(widths, out: str, seed):
    """The JAX package's network (``out``: its output activation) of the
    same parameters as :func:`torch_net` (the worker's)."""
    tmpl = j_gen_net(JB, widths[0], widths[-1],
                     [(h, j_logistic()) for h in widths[1:-1]],
                     j_softmax() if out == "softmax" else j_logistic(),
                     JRng(JB, seed=0))
    same = torch_net(widths, act_softmax() if out == "softmax"
                     else act_logistic(), seed)
    return JNetwork(tmpl.op, tuple(JB.asarray(np.asarray(p))
                                   for p in same.params), tmpl.act_names)


def shard_batches(Xs, Ys, Loader, drop_last=False):
    """The 8 global batches of two processes' loader shards, concatenated
    (the worker's batch of 16: 8 rows a process)."""
    loaders = [Loader(Xs, Ys, batch=8, seed=0, shard=(k, 2),
                      drop_last=drop_last) for k in range(2)]
    for _ in range(8):
        xs, ys = zip(*(ld.next() for ld in loaders))
        yield np.concatenate(xs), np.concatenate(ys)


def port_steps(net, loss, mesh, leaves, specs, zstage, Xs, Ys,
               drop_last=False, pipeline=None):
    """The port's mesh step in one process on the concatenated shards."""
    opt = optim.adam()
    params, state, pins = _mesh_setup(leaves, specs, opt, mesh, TB, zstage)
    step = make_opt_step(net, loss, TB, opt, mesh=mesh, pipeline=pipeline,
                         **pins)
    losses = []
    for xb, yb in shard_batches(Xs, Ys, NativeLoader, drop_last):
        lr = _scalars([0.05], _like(params))[0]
        v, state, params = step(lr, TB.asarray(xb), TB.asarray(yb), state,
                                params)
        losses.append(float(v))
    return losses, [np.asarray(p) for p in params]


def jax_steps(net, loss, Xs, Ys, drop_last=False):
    """The JAX package's unsharded step on one device, same batches."""
    opt = j_adam()
    step = j_make_opt_step(net, loss, JB, opt)
    params = tuple(net.params)
    state = opt.init(params)
    losses = []
    for xb, yb in shard_batches(Xs, Ys, JLoader, drop_last):
        v, state, params = step(0.05, JB.asarray(xb), JB.asarray(yb), state,
                                params)
        losses.append(float(v))
    return losses, [np.asarray(p) for p in params]


def ref_zero3():
    net = torch_net((12, 8, 4), act_softmax(), 0)
    mesh = make_mesh(8, devices=CPU8)
    port = port_steps(net, cross_entropy(4), mesh, net.params,
                      param_specs(net.param_stack, mesh), 3, X, Y)
    jax = jax_steps(jax_net((12, 8, 4), "softmax", 0), j_xent(4), X, Y)
    return port, jax


def ref_pp():
    net = torch_net((8,) * 6, act_logistic(), 5)
    mesh = make_dp_pipeline_mesh(2, 4, devices=CPU8)
    part = IP.partition_network(net, 4, mesh)
    skel = part.skeleton()
    losses, flat = port_steps(net, squared_error(8), mesh,
                              part.flat_params(),
                              IP.pipelined_specs(part, mesh), 0, X2, Y2,
                              drop_last=True, pipeline=(skel, 2, "gpipe"))
    params = skel.unflatten(tuple(torch.as_tensor(p) for p in flat)
                            ).to_network_params()
    jax = jax_steps(jax_net((8,) * 6, "logistic", 5), j_sq(8), X2, Y2,
                    drop_last=True)
    return (losses, [np.asarray(p) for p in params]), jax


def ref_ring():
    kw = dict(epochs=2, batch_size=16, lr=0.05, log_every=1, verbose=False,
              seed=0, chain_steps=1)
    res = fit(torch_net((8,) * 10, act_logistic(), 9), squared_error(8), TB,
              X2, Y2, optimizer=optim.adam(),
              mesh=make_pipeline_mesh(8, devices=CPU8),
              pipeline_microbatches=2, **kw)
    jr = j_fit(jax_net((8,) * 10, "logistic", 9), j_sq(8), JB, X2, Y2,
               optimizer=j_adam(), **kw)
    return (([h["loss"] for h in res.history],
             [np.asarray(p) for p in res.net.params]),
            ([h["loss"] for h in jr.history],
             [np.asarray(p) for p in jr.net.params]))


def ref_seq():
    host = gen_rnet(NB, 1, 1, [(8, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(NB, seed=11))
    rnet = RecurrentNetwork(host.op, tuple(TB.asarray(np.asarray(s))
                                           for s in host.states),
                            tuple(TB.asarray(np.asarray(p))
                                  for p in host.params), host.arch)
    kw = dict(epochs=2, batch_size=16, rate_state=0.01, rate_param=0.1,
              log_every=1, verbose=False, seed=0)
    res = fit_sequences(rnet, squared_error(1), TB, WAVES[:, :-1, None],
                        WAVES[:, 1:, None], mesh=make_mesh(8, devices=CPU8),
                        chain_steps=1, **kw)
    tmpl = j_gen_rnet(JB, 1, 1, [(8, j_logistic(), j_logistic())],
                      j_logistic(), None, JRng(JB, seed=0))
    jnet = JRecurrent(tmpl.op, tuple(JB.asarray(np.asarray(x))
                                     for x in host.states),
                      tuple(JB.asarray(np.asarray(x)) for x in host.params),
                      tmpl.arch)
    jr = j_fit_sequences(jnet, j_sq(1), JB, WAVES[:, :-1, None],
                         WAVES[:, 1:, None], **kw)
    return (([h["loss"] for h in res.history],
             [np.asarray(x) for x in tuple(res.net.states)
              + tuple(res.net.params)]),
            ([h["loss"] for h in jr.history],
             [np.asarray(x) for x in tuple(jr.net.states)
              + tuple(jr.net.params)]))


SCENARIOS = {"zero3": ("losses", "params", ref_zero3),
             "pp": ("pp_losses", "pp_params", ref_pp),
             "ring": ("ring_losses", "ring_params", ref_ring),
             "seq": ("seq_losses", "seq_leaves", ref_seq)}
_refs: dict = {}


def reference(name):
    if name not in _refs:
        _refs[name] = SCENARIOS[name][2]()
    return _refs[name]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_both_processes_report_the_same_run(runs, name):
    lk, pk, _ = SCENARIOS[name]
    assert runs[0][lk] == runs[1][lk]
    assert len(runs[0][lk]) == 8
    assert runs[0][pk] == runs[1][pk]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_processes_bit_equal_to_one_process(runs, name):
    """The crash/resume seam included: the one-process run is
    uninterrupted."""
    lk, pk, _ = SCENARIOS[name]
    (losses, leaves), _ = reference(name)
    assert runs[0][lk] == losses
    assert len(runs[0][pk]) == len(leaves)
    for a, b in zip(runs[0][pk], leaves):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_processes_match_jax_semantics(runs, name):
    lk, pk, _ = SCENARIOS[name]
    _, (losses, leaves) = reference(name)
    np.testing.assert_allclose(runs[0][lk], losses, atol=ATOL, rtol=0)
    assert len(runs[0][pk]) == len(leaves)
    for a, b in zip(runs[0][pk], leaves):
        np.testing.assert_allclose(np.asarray(a), b, atol=ATOL, rtol=0)


API = ("gpipe", "gpipe_fwd", "circular", "ir", "ir_circular", "sharded")
_api: dict = {}


@pytest.mark.parametrize("key", API)
def test_entry_points_across_processes_bit_equal_to_one_process(runs, key):
    """Below fit: a PipelineMLP's GPipe steps, forward and circular step,
    the staged-IR loss, gradients, forward and circular step on the (8,)
    ring, and sharded_train_step / sharded_forward on (2, 4), in both
    processes bit-equal to the same calls in one process."""
    import torch_mp_worker as W

    if not _api:
        _api.update(W.run_api(make_pipeline_mesh(8, devices=CPU8),
                              make_mesh(8, devices=CPU8)))
    assert runs[0]["api"][key] == _api[key]
    assert runs[1]["api"][key] == _api[key]


def test_collectives_across_processes_bit_equal_to_one_process(runs):
    g = np.random.default_rng(3)
    every = [torch.from_numpy(g.standard_normal((8, 1500)).astype(np.float32))
             for _ in range(8)]
    want = {"ar": K.ring_all_reduce_bidir(every),
            "ar_scaled": K.ring_all_reduce_bidir(every, scale=0.125),
            "rs": K.ring_reduce_scatter(every, scale=0.125),
            "ag": K.ring_all_gather(every),
            "ag_dim1": K.ring_all_gather(every, dim=1),
            "one_way": K.ring_all_reduce(every),
            "pair": [None] * 3 + K.ring_all_reduce_bidir(every[3:5])}
    for k, per_rank in want.items():
        for run in runs:
            got = run["coll"][k]
            assert got, k
            for r, x in got.items():
                np.testing.assert_array_equal(
                    np.asarray(x, np.float32), per_rank[int(r)].numpy(),
                    err_msg=f"{k}, rank {r}")


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("dp"), "dp", local=2)


def test_dp_step_across_processes_bit_equal_to_one_process(dp_runs):
    """``dp_megakernel_train_step`` on a ``(4,)`` data mesh of 2 processes
    of 2 CPU ranks: in both processes, three steps' losses and parameters
    and the last step's replicas of its own ranks bit-equal to the same
    mesh in one process; each step's 4 reductions cross the processes (the
    plain fold of gloo's bytes) and the loss's other ranks come in one
    gather over gloo."""
    import torch_mp_worker as W

    one = W.run_dp(TMesh(["cpu"] * 4, ("data",)))
    assert one["gathers"] == 0 and one["xproc"]["ar"] == 0
    for k, run in enumerate(dp_runs):
        got = run["dp"]
        assert got["losses"] == one["losses"]
        assert got["params"] == one["params"]
        assert set(got["replicas"]) == {str(2 * k), str(2 * k + 1)}
        for r, rep in got["replicas"].items():
            assert rep == one["replicas"][r]
        assert got["xproc"]["cpu"] == got["xproc"]["ar"] == 12
        assert got["gathers"] == 3


# ---------------------------------------------------------------------------
# Ports of tests/test_parallel.py's distributed cases and of the alignment
# check of tests/test_multihost.py
# ---------------------------------------------------------------------------


def test_init_distributed_single_process_noop():
    """Single-process (no coordinator configured): init is a no-op that
    still reports the process/device topology."""
    info = D.init_distributed(local_devices=["cpu"] * 2)
    assert info["initialized"] is False
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] >= info["local_devices"] >= 1
    assert D.process_count() == 1 and D.process_index() == 0


def test_init_distributed_env_resolution(monkeypatch):
    """TOPS_* env vars are picked up; with a bogus coordinator the call
    must at least ATTEMPT multi-process init (it reaches
    torch.distributed.init_process_group with the resolved arguments),
    and they win over the launcher's variables."""
    seen = {}

    def fake_init(**kw):
        seen.update(kw)

    monkeypatch.setattr(D, "_initialized", False)
    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setenv("TOPS_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("TOPS_NUM_PROCESSES", "4")
    monkeypatch.setenv("TOPS_PROCESS_ID", "2")
    monkeypatch.setenv("MASTER_ADDR", "10.9.9.9")
    monkeypatch.setenv("WORLD_SIZE", "16")
    info = D.init_distributed(local_devices=["cpu"])
    assert seen["init_method"] == "tcp://10.0.0.1:8476"
    assert (seen["backend"], seen["world_size"], seen["rank"]) == \
        ("gloo", 4, 2)
    assert seen["timeout"].total_seconds() == 60
    assert info["initialized"] is True
    monkeypatch.setattr(D, "_initialized", False)  # restore module state


def test_init_distributed_launcher_env(monkeypatch):
    """Without TOPS_* the launcher's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK (torchrun's) are taken."""
    seen = {}
    monkeypatch.setattr(D, "_initialized", False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: seen.update(kw))
    for k in ("TOPS_COORDINATOR", "TOPS_NUM_PROCESSES", "TOPS_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "29400")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    D.init_distributed(local_devices=["cpu"], timeout_s=5)
    assert seen["init_method"] == "tcp://10.1.2.3:29400"
    assert (seen["world_size"], seen["rank"]) == (8, 5)
    assert seen["timeout"].total_seconds() == 5
    monkeypatch.setattr(D, "_initialized", False)


@pytest.mark.parametrize("env,want", [
    ({"LOCAL_RANK": "2"}, ("cuda:2",)),
    ({"LOCAL_RANK": "2", "TOPS_LOCAL_DEVICES": "cuda:0,cuda:1"},
     ("cuda:0", "cuda:1")),
    ({"LOCAL_RANK": "2", "TOPS_COORDINATOR": "10.0.0.1:8476",
      "TOPS_NUM_PROCESSES": "4", "TOPS_PROCESS_ID": "2"},
     ("cuda:0", "cuda:1", "cuda:2", "cuda:3")),
    ({"LOCAL_RANK": "4"}, "LOCAL_RANK=4 with 4 card"),
])
def test_init_distributed_launcher_local_rank(monkeypatch, env, want):
    """Under torchrun (one process a card: MASTER_ADDR, WORLD_SIZE, RANK
    and LOCAL_RANK) each process takes the card LOCAL_RANK names, not every
    visible card; TOPS_LOCAL_DEVICES still names the ranks where it is set,
    a TOPS_* coordinator keeps the visible cards, and a LOCAL_RANK past the
    visible cards is refused."""
    monkeypatch.setattr(D, "_initialized", False)
    monkeypatch.setattr(D, "_local", None)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k in ("TOPS_COORDINATOR", "TOPS_NUM_PROCESSES", "TOPS_PROCESS_ID",
              "TOPS_LOCAL_DEVICES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(MASTER_ADDR="10.1.2.3", MASTER_PORT="29400",
                     WORLD_SIZE="8", RANK="6", **env).items():
        monkeypatch.setenv(k, v)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            D.init_distributed()
        return
    info = D.init_distributed()
    assert D.local_devices() == want
    assert info["local_devices"] == len(want)


@pytest.mark.parametrize("cards", [
    {0: ["a", "b"], 1: ["c", "d"]},   # two cards a process
    {0: ["a"], 1: ["a", "b"]},        # one card shared, one not
    {0: ["a"], 1: ["b"], 2: ["b"]},   # processes 1 and 2 share a card
])
def test_cross_process_collective_refuses_other_layouts(monkeypatch, cards):
    """Across processes on cards, every process runs on one shared card
    (the one-shot over IPC) or each on a card of its own (the ring
    protocol over IPC).  A process on several cards (it would reach the
    other processes' buffers from cards their mappings were not opened
    on) and processes that share some cards and not others are refused,
    before any launch."""
    table = tuple(D.GlobalDevice(p, f"cuda:{i}", c) for p, cs in cards.items()
                  for i, c in enumerate(cs))
    monkeypatch.setattr(D, "global_devices", lambda: table)
    monkeypatch.setattr(D, "process_index", lambda: 0)
    owner = [g.proc for g in table]
    xs = [torch.zeros(4) if p == 0 else K.remote(p) for p in owner]
    counts = {p: len(c) for p, c in cards.items()}
    n_cards = len({c for cs in cards.values() for c in cs})
    with pytest.raises(ValueError, match=re.escape(
            f"{counts} cards a process, {n_cards} in all")):
        K._ipc_collective(xs, owner, "ar", False)


def test_dryrun_multichip_entrypoint():
    from tensor_ops_tpu_torch import dryrun

    out = dryrun.dryrun_multichip(8, devices=CPU8)
    # every run of the JAX dry run (__graft_entry__.dryrun_multichip), in
    # its order, at 8 ranks
    assert list(out) == [
        "dp_tp", "fit", "fit_adam", "fit_zero2", "fit_zero3",
        "fit_zero3_offload", "gpipe", "staged_ir", "staged_ir_circular",
        "staged_ir_circular_hetero", "staged_ir_flagship", "fit_dp_pipeline",
        "dp_megakernel", "pipeline_3d", "mesh_3d", "hetero_tp_pyramid",
        "hetero_tp_flagship", "hetero_tp_circular", "serve_reload",
        "fit_sequences"]
    assert all(np.isfinite(v) for v in out.values())


def test_process_data_alignment_validation():
    """A mesh whose data rows span processes is rejected with the
    actionable error (the JAX package's text)."""
    bad = SimpleNamespace(axis_names=("data", "model"),
                          shape={"data": 2, "model": 4},
                          rank_procs=(0, 0, 1, 1, 2, 2, 3, 3))
    with pytest.raises(ValueError, match="aligned to process boundaries"):
        _check_process_data_alignment(bad, 4)
    good = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 4, "model": 2},
                           rank_procs=(0, 0, 1, 1, 2, 2, 3, 3))
    _check_process_data_alignment(good, 4)


@pytest.mark.parametrize("extra", ([], ["--pipeline"]))
def test_multihost_launch_example(tmp_path, monkeypatch, capsys, extra):
    """``examples/multihost_launch.py`` on CPU ranks: 2 processes of 4,
    every process reporting the same global loss curve (dp x tp, and the
    stage-only ring across the processes)."""
    import tempfile

    from tensor_ops_tpu_torch.examples import multihost_launch

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the workers' torch pools
    multihost_launch.main(["--cpu"] + extra)
    out = capsys.readouterr().out
    assert "all 2 processes observed the identical global loss curve" in out


@pytest.mark.parametrize("verdict", (False, True))
def test_mixed_precision_route_is_process_0s(monkeypatch, verdict):
    """Under several processes the measured route is process 0's,
    broadcast to the others, whatever this process measured."""
    from tensor_ops_tpu_torch.models import trainer as TR

    told = []
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "broadcast_object",
                        lambda obj, src=0: told.append((obj, src)) or verdict)
    monkeypatch.setattr(TR, "_measure_mp_route",
                        lambda *a, **k: (100.0, 50.0))  # bf16 faster here
    use, rec = TR._decide_mp_route(lambda bf16: None, lambda: ())
    assert use is verdict and told == [(True, 0)]
    assert rec == {"mp_f32_us": 100.0, "mp_bf16_us": 50.0}


@pytest.mark.parametrize("case", ("chain_steps=2", "batch_size=15", "auto"))
def test_several_process_options(monkeypatch, case):
    """Under several processes an int chain_steps > 1 is refused with its
    reason, so is a batch that does not split over the processes, and
    chain_steps="auto" warns that the run goes unchained."""
    from tensor_ops_tpu_torch.models.trainer import _check_mesh_options

    mesh = make_mesh(2, shape=(2, 1), devices=["cpu"] * 2)
    monkeypatch.setattr(D, "process_count", lambda: 2)
    kw = dict(chain_steps="auto", batch_size=16)
    if case == "auto":
        with pytest.warns(UserWarning, match="processes run unchained"):
            _check_mesh_options("fit", TB, mesh, False, 0, False, **kw)
        return
    key, value = case.split("=")
    kw[key] = int(value)
    with pytest.raises(ValueError, match="captured step|divisible by the "
                                         "process count"):
        _check_mesh_options("fit", TB, mesh, False, 0, False, **kw)
