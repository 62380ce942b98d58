"""tensor-ops-dots on PyTorch: train an MLP to classify points inside two
circles and render the learned function as ASCII art — the port of
``apps/dots.py`` (the reference's ``app/Dots.hs``) with the same flags,
defaults, workload and output format.

Backends (the reference's runtime-selectable nl/nv/b triple,
``Dots.hs:139-146,181-186``, its de-facto cross-backend consistency test):

* ``np``    — the NumPy float64 oracle (role of nl/nv)
* ``torch`` — PyTorch in float32 on ``--device`` (default ``cuda``; role
  of b/hmatrix)
* reference aliases ``nl``/``nv`` (-> np) and ``b`` (-> torch) are accepted

The network is drawn on the NumPy oracle's RNG whatever the backend, so one
``--seed`` trains the same network on every backend (and in the JAX
package's app).

    python -m tensor_ops_tpu_torch.apps.dots np torch --minibatch 50
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from ..backend.numpy_backend import NumpyBackend
from ..backend.rng import Rng
from ..backend.torch_backend import TorchBackend
from ..models import act_logistic, gen_net, squared_error
from ..models.feedforward import Network
from ..models.training import batched_run, train_fold, train_minibatch
from ..utils.timing import timed

BACKEND_ALIASES = {
    "np": "np",
    "nl": "np",
    "nv": "np",
    "torch": "torch",
    "b": "torch",
}


def make_backend(name: str, device: str = "cuda"):
    if name == "np":
        return NumpyBackend()
    return TorchBackend(torch.float32, device)


def in_circle(v: np.ndarray, center: float, radius: float) -> bool:
    """Point inside circle centered at (c, c) (``Dots.hs:93-100``)."""
    d = v - center
    return float(d @ d) <= radius**2


def net_test(backend_name: str, rate: float, n: int, hidden: List[int],
             seed: int, minibatch: int = 0, device: str = "cuda") -> str:
    """Train and render (``netTest``, ``Dots.hs:46-100``)."""
    be = make_backend(backend_name, device)
    data_rng = np.random.default_rng(seed)

    def gen_points():
        inps = data_rng.uniform(-1.0, 1.0, size=(n, 2))
        outs = np.array(
            [
                1.0 if (in_circle(v, 0.33, 0.33) or in_circle(v, -0.33, 0.33)) else 0.0
                for v in inps
            ]
        ).reshape(n, 1)
        return inps, outs

    (inps, outs), tp = timed(gen_points)
    print(f"Generated test points ({tp:.3f}s)")

    # the parameters are drawn on the NumPy oracle's RNG whatever the
    # backend, so the same --seed yields the SAME network everywhere: the
    # reference's cross-backend consistency check (Dots.hs:139-146)
    # compares like with like
    oracle = NumpyBackend()
    net = gen_net(oracle, 2, 1, [(h, act_logistic()) for h in hidden],
                  act_logistic(), Rng(oracle, seed=seed))
    if be.name != "numpy":
        net = Network(net.op, tuple(be.asarray(p) for p in net.params),
                      net.act_names)
    loss = squared_error(1)

    def train():
        m = net
        if minibatch > 1:
            xb = be.asarray(inps)
            yb = be.asarray(outs)
            for k in range(0, n, minibatch):
                _, m = train_minibatch(m, loss, be, rate, xb[k:k + minibatch],
                                       yb[k:k + minibatch])
        elif be.name == "torch":
            m = train_fold(m, loss, be, rate, be.asarray(inps),
                           be.asarray(outs))
        else:
            for x, y in zip(inps, outs):
                m = m.train(loss, rate, be, be.asarray(x), be.asarray(y))
        return tuple(m.params)

    params, tn = timed(train)
    trained = Network(net.op, params, net.act_names)
    print(f"Network trained ({tn:.3f}s)")

    # 51x21 ASCII render of (net output)^2 (``join TT.dot . runNetwork``,
    # ``Dots.hs:83-92``)
    def render(r: float) -> str:
        if r <= 0.2:
            return " "
        if r <= 0.4:
            return "."
        if r <= 0.6:
            return "-"
        if r <= 0.8:
            return "="
        return "#"

    grid_pts = np.array(
        [[x / 25 - 1, y / 10 - 1] for y in range(21) for x in range(51)]
    )
    vals = batched_run(trained, be)(be.asarray(grid_pts), *trained.params)
    if isinstance(vals, torch.Tensor):
        vals = vals.cpu().numpy()
    vals = np.asarray(vals, dtype=np.float64).reshape(21, 51) ** 2
    return "\n".join("".join(render(v) for v in row) for row in vals)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="tensor-ops-dots",
        description=(
            "tensor-ops-dots - train neural nets with tensor-ops\n\n"
            "Trains a feed-forward neural network on a 2D classifier using "
            "tensor-ops machinery, with the given backends. (If none "
            "provided, backend defaults to 'torch')\n\n"
            "Backends:\n- np: NumPy (oracle)\n- torch: PyTorch on --device\n"
            "- nl, nv, b: reference aliases for np, np, torch"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-r", "--rate", type=float, default=1.0,
                   help="Neural network learning rate (default: 1.0)")
    p.add_argument("-s", "--samps", type=int, default=50000,
                   help="Number of samples to train the network on (default: 50000)")
    p.add_argument("-l", "--layers", type=str, default="12,8",
                   help="Comma-separated hidden layer sizes (default: 12,8)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed (reproducible runs)")
    p.add_argument("--minibatch", type=int, default=0,
                   help="Train with vmapped minibatches of this size instead of "
                        "per-sample SGD (0 = per-sample like the reference)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device of the torch backend (default: cuda)")
    p.add_argument("backends", nargs="*", default=["torch"],
                   help="Backends to train with: subset of {np, torch, nl, nv, b}")
    args = p.parse_args(argv)

    hidden = [int(x) for x in args.layers.split(",") if x]
    print(f"rate: {args.rate} | samps: {args.samps} | layers: {hidden}")

    for b in args.backends or ["torch"]:
        if b not in BACKEND_ALIASES:
            p.error(f"Unknown backend: {b}")  # before ANY training runs

    seen = []
    for b in args.backends or ["torch"]:
        resolved = BACKEND_ALIASES[b]
        if resolved in seen:
            continue
        seen.append(resolved)
        if (resolved == "torch" and torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            p.error(f"--device {args.device}: CUDA is not available")
        label = {"np": "NumPy (oracle)", "torch": "PyTorch"}[resolved]
        print(f"Training {label} network ...")
        print(net_test(resolved, args.rate, args.samps, hidden, args.seed,
                       args.minibatch, args.device))


if __name__ == "__main__":
    main()
