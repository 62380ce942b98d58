"""FusedMLP: the flagship fast path — ffLayer chains running on the
hand-written CUDA kernels.

Bridges the staged-IR :class:`~tensor_ops_tpu_torch.models.feedforward.
Network` (built by ``gen_net`` with the reference's exact composition) to a
kernel-fused executor: each layer is one ``fused_linear`` launch (matmul +
bias + activation), inference can use the single-launch whole-network
``fused_mlp_forward``, and ``run_xla`` is the same network as plain
PyTorch matmuls (cuBLAS), as the JAX package leaves it to XLA's own GEMM
fusion.  ``train`` is one SGD step by autograd through ``fused_linear``;
``train_fullfused`` is the whole step in the ``fused_mlp_train_step``
kernel.  Both return a new ``FusedMLP`` and leave this one as it was.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import (_act_fn, fused_linear, fused_mlp_forward,
                           fused_mlp_train_step)
from .feedforward import Network


@dataclass
class FusedMLP:
    """weights[k]: (o_k, i_k) — the reference ffLayer layout; acts[k] in
    {logistic, relu, tanh, identity}; final softmax applied in-graph.
    Every weight and bias is a tensor on one device."""

    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    acts: Tuple[str, ...]
    softmax_out: bool = True
    precision: str = "default"
    loss_kind: str = "ce"  # "ce" (cross-entropy) or "mse" (squared error)

    def __post_init__(self):
        self.weights = tuple(self.weights)
        self.biases = tuple(self.biases)
        self.acts = tuple(self.acts)
        if not (len(self.weights) == len(self.biases) == len(self.acts)):
            raise ValueError("FusedMLP: need one weight, bias and "
                             "activation per layer")
        for t in self.weights + self.biases:
            if not isinstance(t, torch.Tensor):
                raise TypeError("FusedMLP holds torch tensors; use "
                                "FusedMLP.from_numpy for numpy arrays")
        if len({t.device for t in self.weights + self.biases}) > 1:
            raise ValueError("FusedMLP: weights and biases must be on "
                             "one device")

    @property
    def device(self) -> torch.device:
        return self.weights[0].device

    # -- conversion ------------------------------------------------------
    @classmethod
    def from_network(cls, net: Network, acts: Optional[Sequence[str]] = None,
                     softmax_out: Optional[bool] = None,
                     precision: str = "default") -> "FusedMLP":
        """From a gen_net-built Network: params alternate (w, b) per layer
        (``ff_layer``; the softmax layer contributes no params).  When the
        Network carries ``act_names`` (set by gen_net) the kernel
        activations are inferred: softmax output -> in-kernel softmax,
        elementwise names pass through."""
        if acts is None:
            if net.act_names is None:
                raise ValueError("acts not given and net has no act_names")
            names = list(net.act_names)
            if softmax_out is None:
                softmax_out = names[-1] == "softmax"
            if names[-1] == "softmax":
                names[-1] = "identity"
            acts = names
        if softmax_out is None:
            softmax_out = True
        ps = net.params
        ws = tuple(ps[i] for i in range(0, len(ps), 2))
        bs = tuple(ps[i] for i in range(1, len(ps), 2))
        return cls(ws, bs, tuple(acts), softmax_out, precision)

    @classmethod
    def from_numpy(cls, weights: Sequence[Any], biases: Sequence[Any],
                   acts: Sequence[str], softmax_out: bool = True,
                   device: "str | torch.device" = "cpu",
                   precision: str = "default",
                   loss_kind: str = "ce") -> "FusedMLP":
        """From host arrays — e.g. the JAX package's FusedMLP parameters
        as numpy arrays — onto ``device``, keeping each array's dtype."""
        def t(a):
            return torch.tensor(np.asarray(a), device=device)  # a copy

        return cls(tuple(t(w) for w in weights), tuple(t(b) for b in biases),
                   tuple(acts), softmax_out, precision, loss_kind)

    def astype(self, dtype: torch.dtype) -> "FusedMLP":
        """Serving-storage variant: weights/biases stored in ``dtype``
        (e.g. ``torch.bfloat16`` — half the weight memory).  Activations
        still compute in f32; the final softmax runs in f32."""
        ws = tuple(w.to(dtype) for w in self.weights)
        bs = tuple(b.to(dtype) for b in self.biases)
        return FusedMLP(ws, bs, self.acts, self.softmax_out,
                        self.precision, self.loss_kind)

    def to_params(self) -> Tuple[torch.Tensor, ...]:
        out: List[torch.Tensor] = []
        for w, b in zip(self.weights, self.biases):
            out += [w, b]
        return tuple(out)

    # -- forward -----------------------------------------------------------
    def _layers_forward(self, x, weights, biases) -> torch.Tensor:
        h = x
        n = len(weights)
        for k in range(n):
            if k == n - 1 and self.softmax_out:
                z = fused_linear(h, weights[k], biases[k], "identity",
                                 self.precision)
                h = torch.softmax(z, dim=-1)
            else:
                h = fused_linear(h, weights[k], biases[k], self.acts[k],
                                 self.precision)
        return h

    def run(self, x) -> torch.Tensor:
        """Layer-by-layer forward, one ``fused_linear`` launch per layer
        (differentiable)."""
        return self._layers_forward(x, self.weights, self.biases)

    def run_xla(self, x) -> torch.Tensor:
        """The same network as plain PyTorch ops (cuBLAS matmuls), the
        counterpart of the JAX package's XLA route.  Weights stored in
        another dtype are promoted to x's, as JAX promotes them."""
        h = x
        n = len(self.weights)
        for k in range(n):
            z = h @ self.weights[k].to(h.dtype).T + self.biases[k].to(h.dtype)
            if k == n - 1 and self.softmax_out:
                h = torch.softmax(z, dim=-1)
            else:
                h = _act_fn(self.acts[k])(z)
        return h

    def run_fused_inference(self, x) -> torch.Tensor:
        """Whole-network forward in one ``fused_mlp_forward`` launch."""
        return fused_mlp_forward(x, self.weights, self.biases, self.acts,
                                 self.softmax_out, precision=self.precision)

    # -- training -----------------------------------------------------------
    def _loss(self, x, y, weights, biases) -> torch.Tensor:
        p = self._layers_forward(x, weights, biases)
        if self.loss_kind == "mse":
            return ((y - p) ** 2).sum(dim=-1).mean()
        # match crossEntropy = -<log p, y>
        return -(y * torch.log(p + 1e-30)).sum(dim=-1).mean()

    def _replaced(self, weights, biases) -> "FusedMLP":
        return FusedMLP(tuple(weights), tuple(biases), self.acts,
                        self.softmax_out, self.precision, self.loss_kind)

    def train(self, rate: float, xb, yb) -> Tuple[torch.Tensor, "FusedMLP"]:
        """One minibatch SGD step by autograd through the per-layer
        ``fused_linear`` (its kernel runs the forward on the card).
        Returns (mean loss as a 0-d tensor, the updated model)."""
        ws = [w.detach().requires_grad_() for w in self.weights]
        bs = [b.detach().requires_grad_() for b in self.biases]
        with torch.enable_grad():
            v = self._loss(xb, yb, ws, bs)
            grads = torch.autograd.grad(v, ws + bs)
        n = len(ws)
        with torch.no_grad():
            new_ws = [w - rate * g for w, g in zip(ws, grads[:n])]
            new_bs = [b - rate * g for b, g in zip(bs, grads[n:])]
        return v.detach(), self._replaced(new_ws, new_bs)

    def train_fullfused(self, rate: float, xb, yb
                        ) -> Tuple[float, "FusedMLP"]:
        """The ENTIRE SGD step (forward, backward, update) in the
        ``fused_mlp_train_step`` kernel: softmax output + cross-entropy
        (the flagship configuration), or, with ``softmax_out=False`` and
        ``loss_kind="mse"``, ``acts[-1]`` output + squared error (the
        autoencoder configuration).  Returns (mean loss, updated model)."""
        if self.softmax_out:
            kind = "softmax_xent"
            if self.loss_kind == "mse":
                raise ValueError("mse loss needs softmax_out=False")
        elif self.loss_kind == "mse":
            kind = "squared_error"
        else:
            raise ValueError(
                "train_fullfused supports softmax+ce or mse without softmax")
        v, ws, bs = fused_mlp_train_step(
            xb, yb, list(self.weights), list(self.biases), rate, self.acts,
            precision=self.precision, loss_kind=kind)
        return float(v), self._replaced(ws, bs)
