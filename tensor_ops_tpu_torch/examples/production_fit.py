#!/usr/bin/env python
"""The production training-to-serving journey, end to end, the port of
``examples/production_fit.py``:

    gen_net -> fit (adamw + cosine schedule + clipping + Polyak EMA +
    metrics + checkpoints) -> simulated crash -> fit(resume=True) picks
    up the remaining budget bit-exactly (EMA included) -> int8
    quantization of the EMA net -> bucketed Predictor serving with
    latency stats.

The model and task are the reference's dots-style toy (2 -> 32 relu -> 2
softmax on the quadrant task), so the script runs in seconds.  On the card
the int8 Predictor serves through ``fused_linear_w8a8``.

    python -m tensor_ops_tpu_torch.examples.production_fit [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (FusedMLP, Predictor, QuantizedMLP,
                                         act_relu, act_softmax,
                                         cross_entropy, fit, gen_net)
from tensor_ops_tpu_torch.models.optim import adamw, cosine_schedule


def make_data(n, seed):
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, 2))
    labels = (X[:, 0] * X[:, 1] > 0).astype(int)  # the dots quadrant task
    return X, np.eye(2)[labels], labels


def main(argv=None) -> dict:
    """Run the journey; returns the served int8 accuracy (``acc``), the
    resumed run's ``FitResult`` (``res``) and the ``Predictor``
    (``pred``)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    p.add_argument("--workdir", default=None,
                   help="where the checkpoints and metrics go (default: a "
                        "new temporary directory)")
    args = p.parse_args(argv)

    be = TorchBackend(torch.float32, args.device)
    X, Y, labels = make_data(2048, seed=0)
    Xv, Yv, lv = make_data(512, seed=1)
    loss = cross_entropy(2)

    workdir = args.workdir or tempfile.mkdtemp(prefix="tops_prod_")
    ck = os.path.join(workdir, "model.npz")
    metrics = os.path.join(workdir, "metrics.jsonl")
    epochs, batch = 8, 64
    schedule = cosine_schedule(0.01, epochs * (len(X) // batch))

    def run(net_seed, total_epochs, resume):
        net = gen_net(be, 2, 2, [(32, act_relu())], act_softmax(),
                      Rng(be, seed=net_seed))
        return fit(
            net, loss, be, X, Y,
            epochs=total_epochs, batch_size=batch,
            optimizer=adamw(weight_decay=0.01), lr_schedule=schedule,
            clip_norm=1.0, ema_decay=0.99,
            val=(Xv, lv), metrics_path=metrics,
            checkpoint_path=ck, checkpoint_every=16,
            resume=resume, log_every=16, verbose=True,
        )

    # --- phase 1: train 1/3 of the budget, then "crash" -----------------
    print(f"== phase 1: {epochs // 3} of {epochs} epochs, then crash ==")
    run(net_seed=42, total_epochs=epochs // 3, resume=False)

    # --- phase 2: resume; epochs is the TOTAL budget, so only the
    # remaining steps run, continuing the exact shuffle stream ----------
    print("== phase 2: resume to the full budget ==")
    res = run(net_seed=999, total_epochs=epochs, resume=True)

    # --- phase 3: quantize + serve the EMA (Polyak-averaged) net --------
    fm = FusedMLP.from_network(res.ema_net)
    pred = Predictor(QuantizedMLP.from_fused(fm), buckets=(8, 64, 512))
    pred.warmup()
    acc = float(np.mean(pred.predict_class(Xv) == lv))
    for _ in range(20):
        pred.predict(Xv[:37])  # odd sizes ride the 64-bucket
    lat = pred.latency()
    print(f"served int8 accuracy {acc:.3f}  "
          f"p50 {lat['p50_s'] * 1e3:.2f} ms over {lat['n']} requests")
    print(f"artifacts in {workdir}: model.npz (servable), "
          f"model.npz.state (exact-resume), metrics.jsonl")
    if not acc > 0.9:
        raise SystemExit(f"the quadrant task should be learnable to >90%, "
                         f"served {acc:.3f}")
    return {"acc": acc, "res": res, "pred": pred}


if __name__ == "__main__":
    main()
