"""tensor-ops-mnist on PyTorch: train an MLP on MNIST with validation,
confusion matrix, white-noise class and digit induction.

The port of ``apps/mnist.py``, with the same flags and defaults
(``MNIST.hs:89-133``) and the same output, except that ``--backend`` is
replaced by ``--device`` (default ``cuda``; asking for CUDA where it is
absent is an error, never a silent CPU run).  Routes:

* per-sample SGD like the reference (default): ``train_fold``;
* ``--minibatch N``: vmapped minibatch SGD (``train_minibatch``);
* ``--minibatch N --fused``: the whole step in the ``fused_mlp_train_step``
  kernel (``FusedMLP.train_fullfused``).

Examples:
    python -m tensor_ops_tpu_torch.apps.mnist --epochs 1 --minibatch 100 --fused
    python -m tensor_ops_tpu_torch.apps.mnist --epochs 1 --device cpu -c
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..backend.base import uniform
from ..backend.rng import Rng
from ..backend.torch_backend import TorchBackend
from ..models import act_logistic, act_softmax, cross_entropy, gen_net
from ..models.fast import FusedMLP
from ..models.feedforward import Network
from ..models.training import (accuracy, batched_run, confusion, train_fold,
                               train_minibatch)
from ..utils.checkpoint import save_network_async
from ..utils.metrics import MetricsLogger
from ..utils.mnist_data import load_mnist, verify_real_mnist
from ..utils.timing import timed


def one_hot(i: int, n: int) -> np.ndarray:
    v = np.zeros(n)
    v[i] = 1.0
    return v


def render_digit(x: np.ndarray) -> str:
    """ASCII-render a 784-vector, each pixel doubled horizontally
    (``renderOut``, ``MNIST.hs:423-446``)."""

    def render(r: float) -> str:
        if r <= 0.2:
            return " "
        if r <= 0.4:
            return "."
        if r <= 0.8:
            return "-"
        if r <= 1.9:
            return "="
        return "#"

    rows = np.asarray(x, dtype=np.float64).reshape(28, 28)
    return "\n".join("".join(render(v) * 2 for v in row) for row in rows)


def print_confusion(mat: np.ndarray) -> None:
    """Predicted-by-actual counts with [i] row labels (the boxes render,
    ``MNIST.hs:335-356``)."""
    n = mat.shape[0]
    width = max(5, len(str(mat.max())) + 1)
    print("     " + "".join(f"{j:>{width}}" for j in range(n)))
    for i in range(n):
        print(f"[{i:>2}] " + "".join(f"{mat[i, j]:>{width}}" for j in range(n)))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="tensor-ops-mnist",
        description="tensor-ops-mnist - train neural nets on MNIST data set\n"
        "Simple test of tensor-ops tensors (PyTorch backend) on MNIST "
        "classification challenge",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-r", "--rate", type=float, default=0.02,
                   help="Neural network learning rate (default: 0.02)")
    p.add_argument("-l", "--layers", type=str, default="300,100",
                   help="Comma-separated hidden layer sizes (default: 300,100)")
    p.add_argument("-b", "--batch", type=int, default=1000,
                   help="Training batch size (default: 1000)")
    p.add_argument("-d", "--data", type=str, default="data/mnist",
                   help="Directory to store/cache MNIST data files")
    p.add_argument("-c", "--noconfusion", action="store_true",
                   help="Disable confusion matrix validation and only display "
                        "%% error every batch")
    p.add_argument("-w", "--white", action="store_true",
                   help='Train with an eleventh "white noise" class to train '
                        "network on negative results")
    p.add_argument("-i", "--induce", type=int, default=None, metavar="DIGIT",
                   help="Every batch, attempt to induce an image of the given "
                        "digit with the trained network")
    p.add_argument("--epochs", type=int, default=0,
                   help="Number of epochs (0 = run until interrupted, like the reference)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device to train on (default: cuda)")
    p.add_argument("--minibatch", type=int, default=0,
                   help="Vmapped minibatch size (0 = per-sample SGD like the reference)")
    p.add_argument("--fused", action="store_true",
                   help="Train minibatches with the whole-step kernel "
                        "(fwd+bwd+SGD; requires --minibatch)")
    p.add_argument("--limit", type=int, default=0,
                   help="Subsample the training set to N samples (0 = all)")
    p.add_argument("--metrics", type=str, default=None,
                   help="Append per-batch metrics to this JSONL file")
    p.add_argument("--require-real-data", action="store_true",
                   help="Refuse the synthetic fallback: verify the on-disk "
                        "IDX files are the canonical MNIST distribution "
                        "(md5 of the .gz files or the exact 60000/10000 "
                        "shape signature) and record a pinned-seed accuracy "
                        "trajectory JSONL (default: <data>/accuracy_seed<seed>"
                        ".jsonl unless --metrics is given)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Save network parameters to this .npz after every batch")
    args = p.parse_args(argv)

    hi = 10 if args.white else 9   # -w adds the eleventh class
    if args.induce is not None and not (0 <= args.induce <= hi):
        p.error(f"Number {args.induce} out of range ({hi})")
    if args.fused and args.minibatch <= 1:
        p.error("--fused requires --minibatch N (the whole-step kernel trains minibatches)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {args.device}: CUDA is not available")

    layers = [int(x) for x in args.layers.split(",") if x]

    train_raw, test_raw = load_mnist(args.data,
                                     require_real=args.require_real_data)
    print("Loaded data.")
    if args.require_real_data and args.metrics is None:
        args.metrics = os.path.join(args.data,
                                    f"accuracy_seed{args.seed}.jsonl")
        print(f"Recording accuracy trajectory to {args.metrics}")

    o = 11 if args.white else 10
    be = TorchBackend(torch.float32, device)
    rng = Rng(be, seed=args.seed)
    shuffle_rng = np.random.default_rng(args.seed + 1)

    if args.limit:
        train_raw = train_raw[: args.limit]

    # processDat: pixels/255, one-hot labels (``MNIST.hs:194-216``)
    tX = np.stack([d / 255.0 for _, d in train_raw]).astype(np.float64)
    tL = np.array([l for l, _ in train_raw])
    vX = np.stack([d / 255.0 for _, d in test_raw]).astype(np.float64)
    vL = np.array([l for l, _ in test_raw])
    tY = np.eye(o)[tL]

    net = gen_net(be, 784, o,
                  [(h, act_logistic()) for h in layers], act_softmax(), rng)
    loss = cross_entropy(o)

    print(f"rate: {args.rate} | batch: {args.batch} | layers: {layers}")
    if args.white:
        print("white noise class enabled")
    if args.induce is not None:
        print(f"inducing: {args.induce}")
    print("Data processed.")

    noise_rng = np.random.default_rng(args.seed + 2)

    metrics = MetricsLogger(args.metrics)
    global_batch = 0
    if args.require_real_data and args.metrics:
        # provenance header: what data this trajectory was measured on
        metrics.log(0, kind="header", seed=args.seed, rate=args.rate,
                    layers=layers, batch=args.batch, white=args.white,
                    limit=args.limit, minibatch=args.minibatch,
                    fused=args.fused, data=verify_real_mnist(args.data))

    def white_extras(n: int):
        """Scaled uniform-noise samples labeled as class 10
        (``MNIST.hs:299-306``)."""
        xs = noise_rng.uniform(0, 1, size=(n, 784)) * noise_rng.uniform(
            0, 1, size=(n, 1)
        )
        return xs, np.full(n, 10)

    vX_dev = be.asarray(vX)   # validation set: one transfer, not per batch

    epoch = 1
    fused_model = None
    ckpt_future = None
    try:
        while args.epochs == 0 or epoch <= args.epochs:
            print(f"[Epoch {epoch}]")
            X, Y, L = tX, tY, tL
            if args.white:
                nx, nl = white_extras(len(tX) // 10)
                X = np.concatenate([X, nx])
                Y = np.concatenate([Y, np.eye(o)[nl]])
                L = np.concatenate([L, nl])
            perm = shuffle_rng.permutation(len(X))
            X, Y, L = X[perm], Y[perm], L[perm]
            print(f"Training on {len(X)} samples in batches of {args.batch} ...")

            for b0 in range(0, len(X), args.batch):
                bnum = b0 // args.batch + 1
                xs, ys, ls = (
                    X[b0 : b0 + args.batch],
                    Y[b0 : b0 + args.batch],
                    L[b0 : b0 + args.batch],
                )
                print(f"Batch {bnum} ...")

                def train_chunk():
                    nonlocal net, fused_model
                    xs_dev, ys_dev = be.asarray(xs), be.asarray(ys)
                    if args.fused:
                        if fused_model is None:
                            fused_model = FusedMLP.from_network(net)
                        for k in range(0, len(xs), args.minibatch):
                            _, fused_model = fused_model.train_fullfused(
                                args.rate,
                                xs_dev[k : k + args.minibatch],
                                ys_dev[k : k + args.minibatch],
                            )
                        # reflect updated params back into the IR network
                        # for validation/induction
                        net = Network(net.op, fused_model.to_params(),
                                      net.act_names)
                    elif args.minibatch > 1:
                        for k in range(0, len(xs), args.minibatch):
                            _, net = train_minibatch(
                                net, loss, be, args.rate,
                                xs_dev[k : k + args.minibatch],
                                ys_dev[k : k + args.minibatch],
                            )
                    else:
                        net = train_fold(net, loss, be, args.rate, xs_dev,
                                         ys_dev)
                    return net.params

                _, t = timed(train_chunk)
                print(f"Trained on {len(xs)} samples in {t:.3f}s")

                if args.white:
                    # only the fresh noise rows transfer each batch; the
                    # real rows sit on the device once (vX_dev)
                    nx, nl = white_extras(len(vX) // 10)
                    vXe_dev = torch.cat([vX_dev, be.asarray(nx)])
                    vLe = np.concatenate([vL, nl])
                else:
                    vXe_dev, vLe = vX_dev, vL

                tscore = accuracy(net, be, be.asarray(xs), ls)
                print(f"Training:   {(1 - tscore) * 100:.2f}% error")
                if args.noconfusion:
                    vscore = accuracy(net, be, vXe_dev, vLe)
                    print(f"Validation: {(1 - vscore) * 100:.2f}% error")
                else:
                    conf = confusion(net, be, vXe_dev, vLe, o)
                    vscore = conf.trace() / conf.sum()
                    print(f"Validation: {(1 - vscore) * 100:.2f}% error")
                    print_confusion(conf)
                global_batch += 1
                metrics.log(global_batch, epoch=epoch,
                            train_err=(1 - tscore), val_err=(1 - vscore),
                            batch_seconds=t)
                if args.checkpoint:
                    if ckpt_future is not None:
                        ckpt_future.result()   # surface prior write errors
                    ckpt_future = save_network_async(args.checkpoint, net)

                if args.induce is not None:
                    target = be.asarray(one_hot(args.induce, o))
                    x0 = rng.draw(uniform(0, 0.05), (784,))
                    # 5000 induction steps (induceNum, MNIST.hs:399-411)
                    x1 = net.induce_many(loss, 1.0, be, target, x0, 5000)
                    print(render_digit(x1.cpu().numpy()))
                    yhat = batched_run(net, be)(x1[None], *net.params)[0]
                    print("/".join(f"{v:.2f}" for v in yhat.cpu().numpy()))
            epoch += 1
    except KeyboardInterrupt:
        print("\nInterrupted.")
    finally:
        if ckpt_future is not None:
            ckpt_future.result()   # join the last async checkpoint write
        metrics.close()


if __name__ == "__main__":
    main()
