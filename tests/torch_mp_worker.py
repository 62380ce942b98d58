"""Multi-process worker of the port (not collected by pytest: launched as a
subprocess by ``test_torch_multihost.py``, one copy per process).

Each process: the CPU ranks that ``TOPS_LOCAL_DEVICES`` names (4 in the
test), wired to the others through ``init_distributed`` (the ``TOPS_*``
variables), a global mesh over every process's ranks, then the port's
production path end to end, as ``tests/mp_worker.py`` drives the JAX
package's: ``fit(mesh=...)`` with each process's loader shard, a
checkpoint written by process 0 mid-run and an exact resume, in four
scenarios (``TOPS_MP_SCENARIOS``, comma-separated, these four by default):

* ``zero3``: the ZeRO-3 ``fit`` on ``(data=2, model=4)``;
* ``pp``: dp x pp, the staged-IR pipeline on ``(data=2, stage=4)``;
* ``ring``: the stage-only ``(8,)`` ring, whose hand-offs cross processes;
* ``seq``: ``fit_sequences`` on ``(2, 4)``;

``api``: the entry points below ``fit`` across both processes (the
pipelines' steps and forwards, the staged-IR loss and gradients,
``sharded_train_step`` / ``sharded_forward``); ``coll``: kernel 9's
phases (and kernel 8) over ranks of both processes, on the inputs every
process draws alike; and ``dp``: three steps of
``dp_megakernel_train_step`` on a ``(data,)`` mesh of every process's
ranks.

``TOPS_MP_OUT`` names the JSON file of this process's losses and the
trained leaves (gathered whole in every process)."""

import json
import os

import numpy as np
import torch

torch.set_num_threads(1)

from tensor_ops_tpu_torch.parallel.distributed import (  # noqa: E402
    init_distributed, shutdown_distributed)
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend  # noqa: E402
from tensor_ops_tpu_torch.backend.rng import Rng  # noqa: E402
from tensor_ops_tpu_torch.models import (Network, act_logistic,  # noqa: E402
                                         act_softmax, cross_entropy,
                                         fit_sequences, gen_net,
                                         squared_error)
from tensor_ops_tpu_torch.models import optim  # noqa: E402
from tensor_ops_tpu_torch.models.recurrent import \
    RecurrentNetwork  # noqa: E402
from tensor_ops_tpu_torch.models.recurrent import \
    gen_net as gen_rnet  # noqa: E402
from tensor_ops_tpu_torch.models.trainer import (  # noqa: E402
    _global_host_tree, fit)
from tensor_ops_tpu_torch.parallel import (  # noqa: E402
    make_dp_pipeline_mesh, make_mesh, make_pipeline_mesh)

NB = NumpyBackend()
TB = TorchBackend(torch.float64, "cpu")
r = np.random.default_rng(0)
X = r.uniform(0, 1, size=(64, 12))
Y = np.eye(4)[r.integers(0, 4, size=64)]
r2 = np.random.default_rng(7)
X2 = r2.uniform(0, 1, size=(64, 8))
Y2 = r2.uniform(0, 1, size=(64, 8))


def torch_net(widths, out_act, seed):
    """The JAX package's parameters (``Rng(NumpyBackend(), seed)`` draws
    its numbers), as f64 CPU tensors: every process builds the same."""
    host = gen_net(NB, widths[0], widths[-1],
                   [(h, act_logistic()) for h in widths[1:-1]], out_act,
                   Rng(NB, seed=seed))
    return Network(host.op, tuple(TB.asarray(np.asarray(p))
                                  for p in host.params), host.act_names)


def legs(run):
    """Leg 1 to the first epoch's end (checkpoints from process 0), leg 2
    resumed from the shared file to the second's."""
    r1 = run(epochs=1, resume=False)
    r2 = run(epochs=2, resume=True)
    assert r1.steps == 4 and r2.steps == 8, (r1.steps, r2.steps)
    return [h["loss"] for h in r1.history + r2.history], r2


def run_api(m8, mesh):
    # the entry points below fit, across both processes: a PipelineMLP's
    # GPipe and circular steps and forward, the staged-IR loss, gradients
    # and forward (GPipe) and circular step on the (8,) ring, and
    # sharded_train_step / sharded_forward on (2, 4)
    from tensor_ops_tpu_torch.parallel import (PipelineMLP,
                                               ir_pipeline_train_step,
                                               make_ir_pipeline_loss,
                                               pipeline_forward,
                                               pipeline_train_step,
                                               shard_network,
                                               shard_pipeline_model,
                                               shard_pipelined_params,
                                               sharded_forward,
                                               sharded_train_step)
    from tensor_ops_tpu_torch.parallel.pipeline import (
        circular_pipeline_train_step, shard_circular_model)

    def host(xs):
        return [np.asarray(x).tolist() for x in xs]

    api = {}
    xb = torch.tensor(X[:64, :12], dtype=torch.float32)
    yb = torch.tensor(Y[:64], dtype=torch.float32)
    pm = shard_pipeline_model(PipelineMLP.init(
        12, 8, 4, n_stages=8, layers_per_stage=1,
        generator=torch.Generator().manual_seed(0), device="cpu"), m8)
    step = pipeline_train_step(pm, m8, n_microbatches=4)
    v1, new = step(0.1, xb, yb, *pm.params())
    v2, new = step(0.1, xb, yb, *new)
    api["gpipe"] = [float(v1), float(v2)] + host(new)
    api["gpipe_fwd"] = pipeline_forward(PipelineMLP(*new), m8, xb,
                                        4).tolist()
    cm = shard_circular_model(PipelineMLP.init(
        12, 8, 4, n_stages=16, layers_per_stage=1,
        generator=torch.Generator().manual_seed(1), device="cpu"), m8)
    v, new = circular_pipeline_train_step(cm, m8, n_microbatches=8)(
        0.1, xb, yb, *cm.params())
    api["circular"] = [float(v)] + host(new)
    net = torch_net((8,) * 10, act_logistic(), 9)
    loss_fn, pnet = make_ir_pipeline_loss(net, squared_error(8), TB, m8, 2)
    flat = shard_pipelined_params(pnet, m8).flat_params()
    v, grads = loss_fn.value_and_grad(flat, X2[:16], Y2[:16])
    api["ir"] = ([float(loss_fn(flat, X2[:16], Y2[:16])), float(v)]
                 + host(grads)
                 + [np.asarray(loss_fn.forward(flat, X2[:16])).tolist()])
    cnet = torch_net((8,) * 18, act_logistic(), 3)
    cstep, cpnet = ir_pipeline_train_step(cnet, squared_error(8), TB, m8,
                                          n_microbatches=8,
                                          schedule="circular", n_chunks=2)
    v, new = cstep(0.05, X2[:16], Y2[:16],
                   *shard_pipelined_params(cpnet, m8).flat_params())
    api["ir_circular"] = [float(v)] + host(new)
    snet = torch_net((12, 8, 4), act_softmax(), 0)
    v, new = sharded_train_step(snet, cross_entropy(4), TB, mesh)(
        0.05, TB.asarray(X[:16]), TB.asarray(Y[:16]),
        *shard_network(snet, mesh).params)
    api["sharded"] = ([float(v)] + host(new) + [np.asarray(sharded_forward(
        snet, TB, mesh)(TB.asarray(X[:16]), *new)).tolist()])
    return api


def run_dp(mesh, steps: int = 3):
    """``steps`` of the data-parallel whole step on ``mesh`` (a 12-16-4
    MLP, the global batch of 32 rows every process passes alike): each
    step's loss and returned parameters, the last step's replicas of this
    process's ranks, the calls of kernels 8-9 across processes and the
    loss's gathers over gloo."""
    from tensor_ops_tpu_torch.parallel import dp_megakernel_train_step
    from tensor_ops_tpu_torch.parallel import collective_kernels as K

    g = np.random.default_rng(21)
    dims = (12, 16, 4)
    ws = [torch.tensor(g.normal(size=(dims[k + 1], dims[k])) * 0.3,
                       dtype=torch.float32) for k in range(2)]
    bs = [torch.tensor(g.normal(size=dims[k + 1]) * 0.1, dtype=torch.float32)
          for k in range(2)]
    xb = torch.tensor(X[:32], dtype=torch.float32)
    yb = torch.tensor(Y[:32], dtype=torch.float32)
    K.reset_xproc_counts()
    step = dp_megakernel_train_step(mesh, ("logistic", "identity"), lr=0.5)
    losses, params = [], []
    for _ in range(steps):
        loss, ws, bs = step(xb, yb, ws, bs)
        losses.append(float(loss))
        params.append([t.tolist() for t in ws + bs])
    return {"losses": losses, "params": params,
            "replicas": {str(r): [t.tolist() for t in rep[0] + rep[1]]
                         for r, rep in enumerate(step.replicas)
                         if mesh.is_local(r)},
            "xproc": K.xproc_counts(), "gathers": step.loss_gathers}


def main() -> None:
    info = init_distributed()
    assert info["initialized"], info
    CK = os.environ["TOPS_MP_CKPT"]
    SCEN = os.environ.get("TOPS_MP_SCENARIOS",
                          "zero3,pp,ring,seq").split(",")
    out = {"rank": info["process_index"], "info": info}

    if "zero3" in SCEN:
        mesh = make_mesh()  # global (data=2, model=4)
        losses, res = legs(lambda epochs, resume: fit(
            torch_net((12, 8, 4), act_softmax(), 0), cross_entropy(4), TB, X, Y,
            epochs=epochs, resume=resume, mesh=mesh, batch_size=16, lr=0.05,
            optimizer=optim.adam(), log_every=1, verbose=False, seed=0,
            checkpoint_path=CK, checkpoint_every=2, zero_stage=3,
            chain_steps=1))
        out["losses"] = losses
        out["params"] = [p.tolist() for p in
                         _global_host_tree(tuple(res.net.params))]

    if "pp" in SCEN:
        mesh2 = make_dp_pipeline_mesh(2, 4)
        losses, res = legs(lambda epochs, resume: fit(
            torch_net((8,) * 6, act_logistic(), 5), squared_error(8), TB, X2,
            Y2, epochs=epochs, resume=resume, mesh=mesh2, batch_size=16,
            lr=0.05, optimizer=optim.adam(), log_every=1, verbose=False,
            seed=0, checkpoint_path=CK + ".pp", checkpoint_every=2,
            pipeline_microbatches=2, chain_steps=1))
        out["pp_losses"] = losses
        out["pp_params"] = [np.asarray(p.cpu()).tolist()
                            for p in res.net.params]

    if "ring" in SCEN:
        mesh3 = make_pipeline_mesh(8)
        losses, res = legs(lambda epochs, resume: fit(
            torch_net((8,) * 10, act_logistic(), 9), squared_error(8), TB, X2,
            Y2, epochs=epochs, resume=resume, mesh=mesh3, batch_size=16,
            lr=0.05, optimizer=optim.adam(), log_every=1, verbose=False,
            seed=0, checkpoint_path=CK + ".ring", checkpoint_every=2,
            pipeline_microbatches=2, chain_steps=1))
        out["ring_losses"] = losses
        out["ring_params"] = [np.asarray(p.cpu()).tolist()
                              for p in res.net.params]

    if "seq" in SCEN:
        mesh = make_mesh()

        def rnet():
            host = gen_rnet(NB, 1, 1, [(8, act_logistic(), act_logistic())],
                            act_logistic(), None, Rng(NB, seed=11))
            return RecurrentNetwork(host.op,
                                    tuple(TB.asarray(np.asarray(s))
                                          for s in host.states),
                                    tuple(TB.asarray(np.asarray(p))
                                          for p in host.params), host.arch)

        t4 = np.linspace(0, 1, 7)
        r4 = np.random.default_rng(11)
        waves = np.sin(2 * np.pi * t4[None, :]
                       + r4.uniform(0, np.pi, size=(64, 1)))
        losses, res = legs(lambda epochs, resume: fit_sequences(
            rnet(), squared_error(1), TB, waves[:, :-1, None],
            waves[:, 1:, None], epochs=epochs, resume=resume, batch_size=16,
            rate_state=0.01, rate_param=0.1, log_every=1, verbose=False, seed=0,
            checkpoint_path=CK + ".seq", checkpoint_every=2, mesh=mesh,
            chain_steps=1))
        out["seq_losses"] = losses
        out["seq_leaves"] = [p.tolist() for p in _global_host_tree(
            tuple(res.net.states) + tuple(res.net.params))]

    if "api" in SCEN:
        out["api"] = run_api(make_pipeline_mesh(8), make_mesh())

    if "coll" in SCEN:
        # kernel 9 (and 8) over ranks of both processes: every process draws
        # all eight ranks' inputs alike and passes its own, Remote markers in
        # place of the others'
        from tensor_ops_tpu_torch.parallel import collective_kernels as K

        mesh = make_mesh()
        g = np.random.default_rng(3)
        every = [g.standard_normal((8, 1500)).astype(np.float32)
                 for _ in range(mesh.size)]
        xs = [torch.from_numpy(every[r]) if mesh.is_local(r) else mesh.remote(r)
              for r in range(mesh.size)]
        got = {"ar": K.ring_all_reduce_bidir(xs),
               "ar_scaled": K.ring_all_reduce_bidir(xs, scale=0.125),
               "rs": K.ring_reduce_scatter(xs, scale=0.125),
               "ag": K.ring_all_gather(xs),
               "ag_dim1": K.ring_all_gather(xs, dim=1),
               "one_way": K.ring_all_reduce(xs),
               "pair": [None] * 3 + K.ring_all_reduce_bidir(xs[3:5]) + [None] * 3}
        out["coll"] = {k: {str(r): v[r].numpy().tolist()
                           for r in mesh.local_ranks if v[r] is not None}
                       for k, v in got.items()}

    if "dp" in SCEN:
        from tensor_ops_tpu_torch.parallel import Mesh
        from tensor_ops_tpu_torch.parallel.distributed import global_devices

        out["dp"] = run_dp(Mesh(global_devices(), ("data",)))

    with open(os.environ["TOPS_MP_OUT"], "w") as f:
        json.dump(out, f)
    shutdown_distributed()


if __name__ == "__main__":
    main()
