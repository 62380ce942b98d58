#!/usr/bin/env python
"""Recurrent network demo: learn to predict sin(t+dt) from sin(t) with an
Elman-style fully connected recurrent layer trained by scan-based BPTT
(the reference's ``Recurrent.hs`` workflow: fullyConnected + trainNetwork'
with dual state/param learning rates), the port of
``examples/recurrent_sine.py``.

    python -m tensor_ops_tpu_torch.examples.recurrent_sine [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import act_logistic, squared_error
from tensor_ops_tpu_torch.models.recurrent import gen_net


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    be = TorchBackend(torch.float32, args.device)
    rng = Rng(be, seed=0)
    net = gen_net(
        be, 1, 1,
        [(8, act_logistic(), act_logistic())],  # recurrent hidden layer
        act_logistic(), None, rng,
    )

    t = np.linspace(0, 4 * np.pi, 81)
    xs = be.asarray((0.5 + 0.5 * np.sin(t[:-1])).reshape(-1, 1))
    tg = be.asarray((0.5 + 0.5 * np.sin(t[1:])).reshape(-1, 1))
    loss = squared_error(1)

    l0 = float(net.seq_loss(loss, be, xs, tg))
    for step in range(300):
        net = net.train(loss, 0.01, 0.05, be, xs, tg)
        if step % 100 == 99:
            l = float(net.seq_loss(loss, be, xs, tg))
            print(f"step {step + 1}: sequence loss {l:.4f}")
    l1 = float(net.seq_loss(loss, be, xs, tg))
    print(f"loss {l0:.4f} -> {l1:.4f}")

    # roll the trained net forward step by step (runNetwork threading state)
    m = net
    preds = []
    for i in range(20):
        y, m = m.run(be, xs[i])
        preds.append(float(y[0]))
    print("first 10 predictions:", [round(p, 2) for p in preds[:10]])
    print("first 10 targets:    ",
          [round(float(v), 2) for v in tg[:10, 0].cpu()])
    if not l1 < l0:
        raise SystemExit(f"the sequence loss did not fall ({l0} -> {l1})")


if __name__ == "__main__":
    main()
