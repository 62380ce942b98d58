#!/usr/bin/env python
"""The operator's pre-flight checklist, end to end (the port of
``examples/plan_and_budget.py``):

    plan_meshes            — which (dp, pp, tp) factorization should this
                             model train on?  (analytic ranking with the
                             partitioners' own numbers)
    training_memory_report — what does the chosen configuration cost per
                             rank, with adam or adam8bit, with or without
                             ZeRO-1?
    memory_analysis        — the bytes of the REAL forward at the batch,
                             measured (``torch.cuda`` memory statistics on
                             the card), to set beside the analytic numbers.

Then one ``fit`` step on the winner.  The 8 ranks sit round-robin on the
visible cards (several ranks share a card when there are fewer), or on the
CPU with ``--cpu``:

    python -m tensor_ops_tpu_torch.examples.plan_and_budget
    python -m tensor_ops_tpu_torch.examples.plan_and_budget --cpu --batch 64
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (act_logistic, act_softmax, adam,
                                         adam8bit, cross_entropy, fit, gen_net)
from tensor_ops_tpu_torch.models.training import batched_run
from tensor_ops_tpu_torch.parallel import describe_plans, make_mesh, plan_meshes
from tensor_ops_tpu_torch.utils.profiling import (memory_analysis,
                                                  training_memory_report)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU (default: the cards)")
    p.add_argument("--batch", type=int, default=4096,
                   help="the global batch (default 4096)")
    args = p.parse_args(argv)

    n_dev, batch = 8, args.batch
    if args.cpu:
        devices = ["cpu"] * n_dev
    elif torch.cuda.is_available():
        devices = [f"cuda:{r % torch.cuda.device_count()}"
                   for r in range(n_dev)]
    else:
        raise SystemExit("no CUDA device is visible; pass --cpu to run the "
                         "ranks on the CPU")
    be = TorchBackend(torch.float32, devices[0])
    # the reference's flagship shape (MNIST.hs:89-104)
    net = gen_net(be, 784, 10, [(300, act_logistic()), (100, act_logistic())],
                  act_softmax(), Rng(be, seed=0))

    print(f"== plan_meshes: {n_dev} ranks on "
          f"{sorted(set(devices))}, batch {batch} ==")
    plans = plan_meshes(net, n_dev, batch_size=batch, optimizer=adam(),
                        shard_opt_state=True)
    print(describe_plans(plans, top=6))
    best = plans[0]["mesh_shape"]
    print(f"\nanalytic winner: (dp={best['data']}, pp={best['stage']}, "
          f"tp={best['model']})")
    if best["stage"] > 1:
        # training_memory_report models dp/tp placements; a pipeline
        # winner's per-stage budget is in the plan table above
        best = next(q["mesh_shape"] for q in plans
                    if q["mesh_shape"]["stage"] == 1)
        print(f"(pipeline winner: per-stage budget in the table; the budget "
              f"and step below use the best pp == 1 mesh (dp={best['data']},"
              f" tp={best['model']}))")

    print("\n== training-state budget for the winner, per optimizer ==")
    mesh = make_mesh(n_dev, shape=(best["data"], best["model"]),
                     devices=devices)
    budget = {}
    for name, opt in (("adam", adam()), ("adam8bit", adam8bit())):
        for zero in (False, True):
            r = training_memory_report(
                net, optimizer=opt, batch_size=batch, mesh=mesh,
                shard_opt_state=zero)["per_device"]
            budget[(name, zero)] = r
            print(f"  {name:8s} zero1={str(zero):5s}  "
                  f"params {r['params_bytes'] / 1e6:6.2f} MB  "
                  f"moments {r['optimizer_bytes'] / 1e6:6.2f} MB  "
                  f"total {r['training_state_total_bytes'] / 1e6:6.2f} MB")

    where = "the card's" if devices[0] != "cpu" else "the CPU's"
    print(f"\n== {where} bytes of the real forward at batch {batch} ==")
    r = np.random.default_rng(0)
    X = r.uniform(0, 1, size=(batch, 784))
    fwd = batched_run(net, be)
    ma = memory_analysis(fwd, be.asarray(X), *net.params)
    print(f"  arguments {ma['argument_size_in_bytes'] / 1e6:.2f} MB  "
          f"outputs {ma['output_size_in_bytes'] / 1e6:.2f} MB  "
          f"temp {ma['temp_size_in_bytes'] / 1e6:.2f} MB  "
          f"total {ma['total_in_bytes'] / 1e6:.2f} MB")

    print("\n== one real step on the winner (fit prints the budget line) ==")
    Y = np.eye(10)[r.integers(0, 10, size=batch)]
    res = fit(net, cross_entropy(10), be, X, Y, epochs=1, batch_size=batch,
              lr=0.05, optimizer=adam(), mesh=mesh, shard_opt_state=True,
              prefetch=0, log_every=1, verbose=True)
    loss = res.history[-1]["loss"]
    print(f"step loss: {loss:.4f}")
    return {"plans": plans, "mesh": best, "budget": budget,
            "memory": ma, "loss": loss}


if __name__ == "__main__":
    main()
