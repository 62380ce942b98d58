"""The plain reference of ``elman-512`` (``elman-512.json``), its data and
its work count.

The Elman layer of ``Recurrent.hs:97-125``: ``z_t = Ws s_{t-1} + Wx x_t +
b`` is the output before its activation and the next state is
``logistic(z_t)``; its output ``h_t = logistic(z_t)`` feeds a stateless
layer ``y_t = logistic(W2 h_t + b2)``.  A sequence's loss is the sum over
its steps of ``|t_t - y_t|^2`` (``NeuralNet.hs:61-68``), meaned over a
batch of sequences.  The leaves are the program's: the initial state
first, then ``Ws, Wx, b, W2, b2``.  Plain PyTorch, in the precision the
caller names (``perfbench.precision``); it imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.precision import dtype_of, matmul

F32 = 4


def _sizes(cfg):
    ((H, act, state_act),) = cfg["hidden"]
    if (act, state_act, cfg["out"][1]) != ("logistic",) * 3:
        raise ValueError("the reference has logistic activations only")
    return cfg["in"], H, cfg["out"][0]


def leaf_shapes(cfg) -> List[tuple]:
    I, H, O = _sizes(cfg)
    return [(H,), (H, H), (H, I), (H,), (O, H), (O,)]


def n_states(cfg) -> int:
    return 1


def make_params(cfg, gen: torch.Generator, device) -> List[torch.Tensor]:
    """The initial state, weights and biases N(mean, std) in float32,
    drawn on ``device`` in one call and cut into the program's leaves."""
    shapes = leaf_shapes(cfg)
    sizes = [torch.Size(s).numel() for s in shapes]
    init = cfg["init"]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat.mul_(init["std"]).add_(init["mean"])
    return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]


def make_data(cfg, gen: torch.Generator, device, sequences=None,
              length=None) -> Dict[str, torch.Tensor]:
    """``X`` (N, n, in) inputs and ``Y`` (N, n, out) targets, standard
    normal float32 on ``device``."""
    I, _, O = _sizes(cfg)
    N = sequences or cfg["data"]["sequences"]
    n = length or cfg["data"]["length"]
    XS = torch.randn(N, n, I, generator=gen, device=device)
    TS = torch.randn(N, n, O, generator=gen, device=device)
    return {"X": XS, "Y": TS}


def _sig(z):
    # 1 / (1 + exp(-z)), its gradient finite where exp(-z) overflows
    return torch.sigmoid(z)


def forward(cfg, leaves, XS: torch.Tensor, prec: str) -> torch.Tensor:
    """Outputs ``(B, n, out)`` of the sequences ``XS`` (B, n, in), each
    started from the stored initial state."""
    dt = dtype_of(prec)
    s0, ws, wx, b, w2, b2 = (t.to(dt) for t in leaves)
    XS = XS.to(dt)
    s = s0.expand(XS.shape[0], -1)
    wst, wxt, w2t = ws.t(), wx.t(), w2.t()
    ys = []
    for t in range(XS.shape[1]):
        z = matmul(s, wst, prec) + matmul(XS[:, t], wxt, prec) + b
        s = _sig(z)
        ys.append(_sig(matmul(s, w2t, prec) + b2))
    return torch.stack(ys, 1)


def loss(cfg, leaves, batch, prec: str) -> torch.Tensor:
    """The batch's mean over sequences of the summed squared error;
    ``batch = (XS, TS)``."""
    XS, TS = batch
    y = forward(cfg, leaves, XS, prec)
    return ((TS.to(y.dtype) - y) ** 2).sum((1, 2)).mean()


def n_params(cfg) -> int:
    return sum(torch.Size(s).numel() for s in leaf_shapes(cfg))


def work(cfg, kind: str, rows: int = 1, steps: int = None,
         optimizer: str = "sgd") -> dict:
    """The algorithm's flops and bytes for ``rows`` sequences of ``steps``
    timesteps (the configuration's length by default).

    ``"forward"``: 2 flops a multiply-add of ``Ws s``, ``Wx x`` and
    ``W2 h`` a step; the inputs, outputs and leaves read or written once.
    ``"train_step"``: one optimizer step on the batch: the forward, the
    weight gradients, and the gradients of the state through ``Ws`` and of
    ``h`` through ``W2`` (none of the inputs); inputs and targets read,
    the leaves read and written once, with ``optimizer="adam"`` its two
    moments too."""
    I, H, O = _sizes(cfg)
    n = steps or cfg["data"]["length"]
    macs = H * H + H * I + O * H
    P = n_params(cfg)
    io = F32 * rows * n * (I + O)
    if kind == "forward":
        return {"flops": 2 * macs * n * rows, "bytes": io + F32 * P}
    if kind == "train_step":
        flops = rows * n * (4 * macs + 2 * H * H + 2 * O * H)
        state = 2 if optimizer == "adam" else 0
        return {"flops": flops, "bytes": io + 2 * F32 * P * (1 + state)}
    raise ValueError(f"no work count for {kind!r}")
