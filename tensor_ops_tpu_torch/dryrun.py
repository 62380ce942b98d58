"""``dryrun_multichip(n)``: one full training step on every parallelism
axis the package runs, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

On an n-rank ``(data, model)`` mesh: a dp + tp step of the flagship MLP
(784 -> 300 -> 100 -> 10, ``sharded_train_step``) and its sharded
forward; a GPipe step of a ``PipelineMLP`` over n stages; a staged-IR
pipeline step of a ``gen_net`` chain over n stages; and, at n >= 8, a
``fit`` step on the 3-D ``(data, stage, model)`` mesh.  The ranks are the
visible cards by default (several ranks may share one:
``devices=["cuda:0"] * n``), or ``devices=["cpu"] * n``; every collective
is kernel 9.  Returns each run's loss; raises on a non-finite one.

    python -m tensor_ops_tpu_torch.dryrun 8 [--cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    from .backend.rng import Rng
    from .backend.torch_backend import TorchBackend
    from .models import (act_logistic, act_softmax, cross_entropy, fit,
                         gen_net)
    from .parallel import (PipelineMLP, make_3d_pipeline_mesh, make_mesh,
                           make_pipeline_mesh, pipeline_train_step,
                           shard_network, shard_pipeline_model,
                           sharded_forward, sharded_train_step)
    from .parallel.ir_pipeline import (ir_pipeline_train_step,
                                       shard_pipelined_params)
    from .parallel.mesh import mesh_devices

    devs = mesh_devices(devices, n_devices, "dryrun_multichip")
    be = TorchBackend(torch.float32, devs[0])
    out = {}

    # dp + tp: the flagship's real widths (the 10-wide output does not
    # divide tp = 4, so param_specs shards its 100-wide input side)
    mesh = make_mesh(n_devices, devices=devs)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    i, h1, h2, o = 784, 300, 100, 10
    net = gen_net(be, i, o, [(h1, act_logistic()), (h2, act_logistic())],
                  act_softmax(), Rng(be, seed=0))
    loss = cross_entropy(o)
    snet = shard_network(net, mesh)
    batch = 2 * dp
    g = np.random.default_rng(1)
    xb = be.asarray(g.uniform(0, 1, size=(batch, i)))
    yb = be.asarray(np.eye(o)[g.integers(0, o, size=batch)])
    v, new = sharded_train_step(net, loss, be, mesh)(0.1, xb, yb,
                                                     *snet.params)
    out["dp_tp"] = float(v)
    if tp > 1:
        split = sum(1 for p in new if p.ndim == 2 and p.mdim is not None)
        assert split == 3, f"expected 3 model-sharded weights, got {split}"
    probs = sharded_forward(net, be, mesh)(xb, *new)
    assert tuple(probs.shape) == (batch, o)

    # GPipe over n stages
    pmesh = make_pipeline_mesh(n_devices, devices=devs)
    gen = torch.Generator().manual_seed(0)
    pmodel = shard_pipeline_model(
        PipelineMLP.init(i, 2 * tp, o, n_stages=n_devices,
                         layers_per_stage=1, generator=gen,
                         device=devs[0]), pmesh)
    pv, _ = pipeline_train_step(pmodel, pmesh, n_microbatches=2)(
        0.1, xb, yb, *pmodel.params())
    out["gpipe"] = float(pv)

    # the staged-IR pipeline of a gen_net chain over n stages
    h = 8
    irnet = gen_net(be, h, h, [(h, act_logistic())] * (n_devices - 1),
                    act_logistic(), Rng(be, seed=2))
    irstep, irpnet = ir_pipeline_train_step(irnet, cross_entropy(h), be,
                                            pmesh, n_microbatches=2)
    xh = be.asarray(g.uniform(0, 1, size=(batch, h)))
    yh = be.asarray(np.eye(h)[g.integers(0, h, size=batch)])
    iv, _ = irstep(0.1, xh, yh,
                   *shard_pipelined_params(irpnet, pmesh).flat_params())
    out["staged_ir"] = float(iv)

    # the 3-D (data, stage, model) mesh: one fit step
    if n_devices >= 8 and n_devices % 4 == 0:
        m3 = make_3d_pipeline_mesh(2, n_devices // 4, 2, devices=devs)
        net3 = gen_net(be, h, h,
                       [(2 * h, act_logistic())] * (2 * (n_devices // 4)),
                       act_logistic(), Rng(be, seed=3))
        X3 = g.uniform(0, 1, size=(8, h))
        Y3 = np.eye(h)[g.integers(0, h, size=8)]
        res = fit(net3, cross_entropy(h), be, X3, Y3, epochs=1, batch_size=8,
                  lr=0.05, mesh=m3, pipeline_microbatches=2, log_every=1,
                  verbose=False)
        out["mesh_3d"] = res.history[-1]["loss"]
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"non-finite losses: {bad}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (default: the visible cards, shared "
                         "round-robin when fewer than n)")
    args = ap.parse_args(argv)
    if args.cpu:
        devices = ["cpu"] * args.n
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise SystemExit("no CUDA device is visible; pass --cpu")
        devices = [f"cuda:{r % count}" for r in range(args.n)]
    print(dryrun_multichip(args.n, devices))


if __name__ == "__main__":
    main()
