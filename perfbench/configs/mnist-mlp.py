"""The plain reference of ``mnist-mlp`` (``mnist-mlp.json``), its data and
its work count.

A chain of fully connected layers, ``h = act(x @ W.T + b)`` with ``W`` of
shape (out, in) as the program stores it, logistic hidden layers and a
softmax output, and the cross-entropy ``-sum(t * log(p))`` of a row,
meaned over a batch (``NeuralNet.hs:70-77``).  Plain PyTorch, in the
precision the caller names (``perfbench.precision``); it imports nothing
of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.precision import dtype_of, matmul

F32 = 4  # bytes of a float32


def layers(cfg) -> List[tuple]:
    """``(out, in, activation)`` of each layer."""
    sizes = [cfg["in"]] + [h for h, _ in cfg["hidden"]] + [cfg["out"][0]]
    acts = [a for _, a in cfg["hidden"]] + [cfg["out"][1]]
    return [(sizes[k + 1], sizes[k], acts[k]) for k in range(len(acts))]


def leaf_shapes(cfg) -> List[tuple]:
    return [s for o, i, _ in layers(cfg) for s in ((o, i), (o,))]


def n_states(cfg) -> int:
    return 0


def make_params(cfg, gen: torch.Generator, device) -> List[torch.Tensor]:
    """Every weight and bias N(mean, std) in float32, drawn on ``device``
    in one call and cut into leaves in the program's order."""
    shapes = leaf_shapes(cfg)
    sizes = [torch.Size(s).numel() for s in shapes]
    init = cfg["init"]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat.mul_(init["std"]).add_(init["mean"])
    return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]


def _digits(gen, device, protos, rows: int, levels: int, block=8192):
    """``rows`` noisy digits and their labels, made a block of rows at a
    time so that the card holds little beside the result."""
    labels = torch.randint(0, protos.shape[0], (rows,), generator=gen,
                           device=device)
    X = torch.empty(rows, protos.shape[1], device=device)
    for a in range(0, rows, block):
        x = X[a:a + block]
        torch.randn(x.shape, generator=gen, device=device, out=x)
        x.mul_(0.15).add_(protos[labels[a:a + block]], alpha=0.8)
        # pixels of 256 levels, read as level / 255 (the app's processDat)
        x.clamp_(0.0, 1.0).mul_(levels - 1).floor_().div_(levels - 1)
    return X, labels


def make_data(cfg, gen: torch.Generator, device, train_rows=None,
              test_rows=None) -> Dict[str, torch.Tensor]:
    """Pseudo-MNIST of the published shape, on ``device``: a smooth random
    prototype per class, each row its class's prototype plus noise (the
    pattern of the program's ``mnist_data._synthesize``, drawn from the
    benchmark's seed).  ``X``, ``Xv`` float32 rows in [0, 1]; ``L``,
    ``Lv`` int64 class labels; ``Y`` the one-hot float32 targets of
    ``X``."""
    d = cfg["data"]
    protos = torch.rand(d["classes"], d["pixels"], generator=gen,
                        device=device)
    protos = (protos + protos.roll(1, 1) + protos.roll(-1, 1)) / 3.0
    X, L = _digits(gen, device, protos, train_rows or d["train_rows"],
                   d["pixel_levels"])
    Xv, Lv = _digits(gen, device, protos, test_rows or d["test_rows"],
                     d["pixel_levels"])
    Y = torch.nn.functional.one_hot(L, d["classes"]).float()
    return {"X": X, "Y": Y, "L": L, "Xv": Xv, "Lv": Lv}


def _act(name: str, z: torch.Tensor) -> torch.Tensor:
    if name == "logistic":
        return torch.sigmoid(z)  # 1 / (1 + exp(-z)), its gradient finite
    if name == "softmax":
        return torch.softmax(z, dim=-1)
    raise ValueError(f"no reference for activation {name!r}")


def forward(cfg, leaves, X: torch.Tensor, prec: str) -> torch.Tensor:
    """Class probabilities of the rows ``X``."""
    dt = dtype_of(prec)
    h = X.to(dt)
    for k, (_, _, act) in enumerate(layers(cfg)):
        W, b = leaves[2 * k].to(dt), leaves[2 * k + 1].to(dt)
        h = _act(act, matmul(h, W.t(), prec) + b)
    return h


def loss(cfg, leaves, batch, prec: str) -> torch.Tensor:
    """The batch's mean cross-entropy; ``batch = (X, one-hot targets)``."""
    X, Y = batch
    p = forward(cfg, leaves, X, prec)
    return -(Y.to(p.dtype) * torch.log(p)).sum(-1).mean()


def n_params(cfg) -> int:
    return sum(o * i + o for o, i, _ in layers(cfg))


def work(cfg, kind: str, rows: int = 1, optimizer: str = "sgd") -> dict:
    """The algorithm's flops and bytes, whatever implements it.

    ``"forward"``: ``rows`` rows through the net, 2 flops a multiply-add,
    each input row, weight and output read or written once.
    ``"train_step"``: one optimizer step on a batch of ``rows``: the
    forward, the weight gradients, the input gradients of every layer but
    the first; the batch and targets read, the parameters read and written
    once, and with ``optimizer="adam"`` its two moments too."""
    macs = sum(o * i for o, i, _ in layers(cfg))
    i0, o_last = cfg["in"], cfg["out"][0]
    P = n_params(cfg)
    if kind == "forward":
        return {"flops": 2 * macs * rows,
                "bytes": F32 * (rows * (i0 + o_last) + P)}
    if kind == "train_step":
        dx = sum(o * i for o, i, _ in layers(cfg)[1:])
        flops = rows * (2 * macs + 2 * macs + 2 * dx)
        state = 2 if optimizer == "adam" else 0
        return {"flops": flops,
                "bytes": F32 * (rows * (i0 + o_last) + 2 * P * (1 + state))}
    raise ValueError(f"no work count for {kind!r}")
