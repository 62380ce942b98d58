#!/usr/bin/env python
"""Autoencoder demo: compress (pseudo-)MNIST digits through a small
bottleneck and report reconstruction loss — the reference's
``AutoEncoder.hs`` workflow (trainEncoder on squared error), the port of
``examples/autoencoder_digits.py``: 784 -> 128 -> 32 -> 128 -> 784,
logistic, per-sample joint SGD on 200 digits for 3 epochs.

    python -m tensor_ops_tpu_torch.examples.autoencoder_digits [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import act_logistic, gen_net, squared_error
from tensor_ops_tpu_torch.models.autoencoder import Encoder
from tensor_ops_tpu_torch.utils.mnist_data import load_mnist


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    p.add_argument("-d", "--data", default="data/mnist",
                   help="MNIST directory (synthetic digits when offline)")
    args = p.parse_args(argv)

    be = TorchBackend(torch.float32, args.device)
    rng = Rng(be, seed=0)
    enc = Encoder(
        gen_net(be, 784, 32, [(128, act_logistic())], act_logistic(), rng),
        gen_net(be, 32, 784, [(128, act_logistic())], act_logistic(), rng),
    )
    loss = squared_error(784)

    train, _ = load_mnist(args.data)
    xs = [be.asarray(d / 255.0) for _, d in train[:200]]

    l0 = float(np.mean([enc.test_loss(loss, be, x) for x in xs[:20]]))
    print(f"initial reconstruction loss: {l0:.3f}")
    for epoch in range(3):
        for x in xs:
            enc = enc.train(loss, 0.05, be, x)
        l = float(np.mean([enc.test_loss(loss, be, x) for x in xs[:20]]))
        print(f"epoch {epoch + 1}: reconstruction loss {l:.3f}")
    if not l < l0:
        raise SystemExit(f"reconstruction loss did not fall ({l0} -> {l})")


if __name__ == "__main__":
    main()
