#!/usr/bin/env python
"""Pipeline-parallel training demo: a GPipe-microbatched MLP across
pipeline stages (optionally combined with data and tensor parallelism on a
3-D mesh), showing the loss converging; the port of
``examples/pipeline_parallel.py``.  The ranks sit round-robin on the
visible cards (several ranks share a card when there are fewer cards than
ranks), or on the CPU with ``--cpu``.

    python -m tensor_ops_tpu_torch.examples.pipeline_parallel            # 1d: 4 stages
    python -m tensor_ops_tpu_torch.examples.pipeline_parallel --mesh 3d  # (data=2, stage=2, model=2)
    python -m tensor_ops_tpu_torch.examples.pipeline_parallel --cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tensor_ops_tpu_torch.parallel.pipeline import (PipelineMLP,
                                                    make_3d_pipeline_mesh,
                                                    make_dp_pipeline_mesh,
                                                    make_pipeline_mesh,
                                                    pipeline_train_step,
                                                    shard_pipeline_model)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", choices=["1d", "2d", "3d"], default="1d")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU (default: the cards)")
    args = p.parse_args(argv)

    n = {"1d": 4, "2d": 8, "3d": 8}[args.mesh]
    if args.cpu:
        devices = ["cpu"] * n
    elif torch.cuda.is_available():
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(n)]
    else:
        raise SystemExit("no CUDA device is visible; pass --cpu to run the "
                         "ranks on the CPU")
    if args.mesh == "1d":
        mesh = make_pipeline_mesh(4, devices=devices)
        stages, lps = 4, 1
    elif args.mesh == "2d":
        mesh = make_dp_pipeline_mesh(2, 4, devices=devices)
        stages, lps = 4, 1
    else:
        mesh = make_3d_pipeline_mesh(2, 2, 2, devices=devices)
        stages, lps = 2, 2
    print(f"mesh: {dict(mesh.shape)} on {sorted({str(d) for d in devices})}")

    dev = devices[0]
    model = shard_pipeline_model(
        PipelineMLP.init(4, 16, 2, n_stages=stages, layers_per_stage=lps,
                         generator=torch.Generator().manual_seed(0),
                         scale=4.0, device=dev), mesh)
    step = pipeline_train_step(model, mesh, n_microbatches=4)

    r = np.random.default_rng(0)
    X = r.uniform(-1, 1, size=(64, 4)).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, 0] * X[:, 1] > 0).astype(int)]
    xb = torch.as_tensor(X, device=dev)
    yb = torch.as_tensor(Y, device=dev)

    params = model.params()
    losses = []
    for t in range(args.steps):
        v, params = step(0.5, xb, yb, *params)
        losses.append(float(v))
        if t % 50 == 0 or t == args.steps - 1:
            print(f"step {t}: loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
