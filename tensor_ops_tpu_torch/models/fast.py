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
``FusedAutoencoder`` trains an encoder>>decoder chain on reconstruction
through the same kernel in its squared-error mode.

``QuantizedMLP`` is the int8 serving model: per-channel int8 weights
served through ``fused_linear_w8a8`` or ``fused_linear_w8`` per layer, or,
for a uniform stack, the whole-MLP ``fused_mlp_w8a8_forward``.

``FusedRNN`` is the Elman layer (the recurrent ``fully_connected`` cell)
driven over a sequence either by a loop of plain PyTorch steps
(``impl="xla"``) or by one ``fused_rnn_seq`` call, one launch of the
sequence kernel on the card (``impl="pallas"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import (_act_fn, _check_names, fused_linear,
                           fused_linear_w8, fused_linear_w8a8,
                           fused_mlp_forward, fused_mlp_train_step,
                           fused_mlp_w8a8_forward, fused_rnn_seq, pad_codes,
                           quantize_weights_int8)
from .feedforward import Network


@dataclass
class FusedMLP:
    """weights[k]: (o_k, i_k) — the reference ffLayer layout; acts[k] in
    {logistic, relu, tanh, identity}; final softmax applied in-graph.
    Every weight and bias is a tensor on one device, or (``parallel.mesh.
    shard_fused``) every one a ``Sharded`` leaf on one mesh: such a model
    runs ``run_xla`` only (``parallel.tp.fused_forward``), the kernels
    taking whole tensors."""

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
        leaves = self.weights + self.biases
        if self.sharded:
            if len({getattr(t, "mesh", None) for t in leaves}) > 1:
                raise ValueError("FusedMLP: a sharded model's weights and "
                                 "biases must all be Sharded on one mesh")
            return
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                raise TypeError("FusedMLP holds torch tensors; use "
                                "FusedMLP.from_numpy for numpy arrays")
        if len({t.device for t in leaves}) > 1:
            raise ValueError("FusedMLP: weights and biases must be on "
                             "one device")

    @property
    def sharded(self) -> bool:
        """Whether the weights are ``Sharded`` leaves on a mesh
        (``parallel.mesh.shard_fused``)."""
        return hasattr(self.weights[0], "shards")

    @property
    def device(self) -> torch.device:
        """The device the model's requests go to (on a mesh: rank 0's)."""
        w = self.weights[0]
        return w.local.device if self.sharded else w.device

    def _whole_only(self, what: str) -> None:
        if self.sharded:
            raise ValueError(
                f"FusedMLP.{what}: the kernels take whole weights; a "
                f"sharded model (shard_fused) runs run_xla")

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
                   device: "str | torch.device" = "cuda",
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
        if self.sharded:
            ws = tuple(w.map(lambda t: t.to(dtype)) for w in self.weights)
            bs = tuple(b.map(lambda t: t.to(dtype)) for b in self.biases)
        else:
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
        self._whole_only("run")
        return self._layers_forward(x, self.weights, self.biases)

    def run_xla(self, x) -> torch.Tensor:
        """The same network as plain PyTorch ops (cuBLAS matmuls), the
        counterpart of the JAX package's XLA route.  Weights stored in
        another dtype are promoted to x's, as JAX promotes them.  A sharded
        model runs the same layers tensor-parallel on its mesh
        (``parallel.tp.fused_forward``)."""
        if self.sharded:
            from ..parallel.tp import fused_forward

            return fused_forward(self, x)
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
        self._whole_only("run_fused_inference")
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
        self._whole_only("train")
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
        self._whole_only("train_fullfused")
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


@dataclass
class FusedAutoencoder:
    """The encoder>>decoder ffLayer chain as one ``FusedMLP`` trained on
    reconstruction (target = input) by the whole-step kernel in its
    squared-error mode: the kernel-fused executor for ``Encoder`` /
    ``trainEncoder`` (``AutoEncoder.hs:87-110``).

    ``n_enc`` records where the encoder's layer stack ends, so the model
    converts back to the staged-IR ``Encoder``."""

    mlp: FusedMLP
    n_enc: int

    @classmethod
    def from_encoder(cls, enc, precision: str = "default"
                     ) -> "FusedAutoencoder":
        fe = FusedMLP.from_network(enc.encoder, softmax_out=False,
                                   precision=precision)
        fd = FusedMLP.from_network(enc.decoder, softmax_out=False,
                                   precision=precision)
        mlp = FusedMLP(fe.weights + fd.weights, fe.biases + fd.biases,
                       fe.acts + fd.acts, softmax_out=False,
                       precision=precision, loss_kind="mse")
        return cls(mlp, len(fe.weights))

    def to_encoder(self, enc):
        """Write the trained params back into a template staged-IR
        Encoder."""
        ps = self.mlp.to_params()
        ne = 2 * self.n_enc
        return type(enc)(
            Network(enc.encoder.op, ps[:ne], enc.encoder.act_names),
            Network(enc.decoder.op, ps[ne:], enc.decoder.act_names),
        )

    def encode_decode(self, x) -> torch.Tensor:
        return self.mlp.run(x)

    def train(self, rate: float, xb) -> Tuple[float, "FusedAutoencoder"]:
        """One joint SGD step on reconstruction loss, the whole step in one
        ``fused_mlp_train_step`` launch on the card."""
        v, m = self.mlp.train_fullfused(rate, xb, xb)
        return v, FusedAutoencoder(m, self.n_enc)


@dataclass
class QuantizedMLP:
    """int8 serving model: per-channel symmetric int8 codes of every
    ffLayer weight (``wqs[k]`` (o_k, i_k) int8, ``scales[k]`` (o_k, 1)
    f32, ``biases[k]`` (o_k,) f32), all on one device, with two modes:

    - ``mode="w8a8"`` (default): activations quantized per row, int8 x
      int8 -> int32 (``fused_linear_w8a8``);
    - ``mode="w8"``: weight-only int8, dequantized in the kernel and
      rounded to bf16 with x (``fused_linear_w8``).

    The model is immutable: the kernels' forms of the weights (codes padded
    to 16-byte rows, the layer stack of ``run_fused``) are made once per
    model and cached, never per request.  A uniform 128-multiple stack
    holds its codes as views of one ``(L, N, N)`` tensor, so the stack
    costs no second copy."""

    wqs: Tuple[torch.Tensor, ...]
    scales: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    acts: Tuple[str, ...]
    softmax_out: bool = True
    mode: str = "w8a8"
    _cache: dict = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.mode not in ("w8", "w8a8"):
            raise ValueError(f"unknown QuantizedMLP mode {self.mode!r}")
        self.wqs, self.scales = tuple(self.wqs), tuple(self.scales)
        self.biases, self.acts = tuple(self.biases), tuple(self.acts)
        if not (len(self.wqs) == len(self.scales) == len(self.biases)
                == len(self.acts)) or not self.wqs:
            raise ValueError("QuantizedMLP: need one code matrix, scale, "
                             "bias and activation per layer")
        ts = self.wqs + self.scales + self.biases
        if not all(isinstance(t, torch.Tensor) for t in ts):
            raise TypeError("QuantizedMLP holds torch tensors; use "
                            "QuantizedMLP.from_numpy for numpy arrays")
        if len({t.device for t in ts}) > 1:
            raise ValueError("QuantizedMLP: codes, scales and biases must "
                             "be on one device")
        if any(q.dtype != torch.int8 for q in self.wqs):
            raise ValueError("QuantizedMLP: codes must be int8")
        if self._cache is None:
            self._cache = {}
        if self.uniform() and "stacked" not in self._cache:
            # one (L, N, N) copy; the per-layer codes become its views
            stack = torch.stack(self.wqs)
            self.wqs = tuple(stack.unbind(0))
            self._cache["stacked"] = (
                stack, torch.stack([s.reshape(-1) for s in self.scales]),
                torch.stack(self.biases))

    @property
    def device(self) -> torch.device:
        return self.wqs[0].device

    def uniform(self) -> bool:
        """Every layer N x N with N % 128 == 0: the stacks the whole-MLP
        kernel ``fused_mlp_w8a8_forward`` takes."""
        n = self.wqs[0].shape[1]
        return n % 128 == 0 and all(tuple(q.shape) == (n, n)
                                    for q in self.wqs)

    @classmethod
    def from_fused(cls, fm: FusedMLP, mode: str = "w8a8") -> "QuantizedMLP":
        """Quantize a FusedMLP's weights on their device; biases to f32."""
        qs, ss = zip(*(quantize_weights_int8(w) for w in fm.weights))
        return cls(tuple(qs), tuple(ss),
                   tuple(b.to(torch.float32) for b in fm.biases), fm.acts,
                   fm.softmax_out, mode)

    @classmethod
    def from_numpy(cls, wqs: Sequence[Any], scales: Sequence[Any],
                   biases: Sequence[Any], acts: Sequence[str],
                   softmax_out: bool = True, mode: str = "w8a8",
                   device: "str | torch.device" = "cuda") -> "QuantizedMLP":
        """From host arrays — e.g. the JAX package's QuantizedMLP arrays
        as numpy — onto ``device``: codes int8, scales and biases f32."""
        def t(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(tuple(t(q, torch.int8) for q in wqs),
                   tuple(t(s, torch.float32) for s in scales),
                   tuple(t(b, torch.float32) for b in biases), tuple(acts),
                   softmax_out, mode)

    def _padded(self) -> Tuple[torch.Tensor, ...]:
        padded = self._cache.get("padded")
        if padded is None:
            padded = tuple(pad_codes(q) for q in self.wqs)
            self._cache["padded"] = padded
        return padded

    def run(self, x) -> torch.Tensor:
        """Layer by layer, one ``fused_linear_w8a8`` (or ``fused_linear_w8``)
        launch per layer; softmax over the last layer when ``softmax_out``."""
        layer = fused_linear_w8a8 if self.mode == "w8a8" else fused_linear_w8
        h = x
        n = len(self.wqs)
        for k, (q, s, b) in enumerate(zip(self._padded(), self.scales,
                                          self.biases)):
            if k == n - 1 and self.softmax_out:
                h = torch.softmax(layer(h, q, s, b, "identity"), dim=-1)
            else:
                h = layer(h, q, s, b, self.acts[k])
        return h

    def run_fused(self, x) -> torch.Tensor:
        """The whole MLP through ``fused_mlp_w8a8_forward``: needs a uniform
        128-multiple stack and one shared hidden activation.  The kernel
        gives raw logits; the softmax, or ``acts[-1]`` when
        ``softmax_out=False``, is applied here, so ``run_fused`` computes
        what ``run`` does."""
        if not self.uniform():
            raise ValueError("run_fused needs a uniform 128-multiple stack")
        hidden = set(self.acts[:-1])
        if len(hidden) > 1:
            raise ValueError(
                f"run_fused needs one hidden activation, got {hidden}")
        act = next(iter(hidden)) if hidden else "identity"
        z = fused_mlp_w8a8_forward(x, *self._cache["stacked"], act)
        if self.softmax_out:
            return torch.softmax(z, dim=-1)
        return _act_fn(self.acts[-1])(z)


RNN_IMPLS = ("xla", "pallas")


@dataclass
class FusedRNN:
    """Fused Elman recurrent layer (the ``fullyConnected`` cell,
    ``Recurrent.hs:97-125``) run over a sequence.
    Parameters follow the reference layout: wX (o, i), wS (o, o), b (o,),
    and the initial state s0 (o,), all tensors on one device.

    ``impl`` keeps the JAX package's names, for callers that pass them:

    - ``"xla"`` (default): each step is the plain PyTorch cell
      ``wX @ xt + wS @ s + b`` and the activation (cuBLAS on the card, no
      hand-written kernel), as the JAX package leaves it to XLA;
    - ``"pallas"``: the whole sequence is one ``fused_rnn_seq`` call: on
      the card one launch of the hand-written sequence kernel (or, for a
      cell too wide for it, one ``fused_rnn_step`` launch per step), on the
      CPU its plain version.

    The model is immutable: ``train`` returns a new one, with the same
    ``impl``."""

    wX: torch.Tensor
    wS: torch.Tensor
    b: torch.Tensor
    s0: torch.Tensor   # initial state (o,)
    act: str = "logistic"
    precision: str = "default"
    impl: str = "xla"

    def __post_init__(self):
        _check_names([self.act], self.precision)
        if self.impl not in RNN_IMPLS:
            raise ValueError(f"unknown FusedRNN impl {self.impl!r} "
                             f"(known: {RNN_IMPLS})")
        ts = (self.wX, self.wS, self.b, self.s0)
        if not all(isinstance(t, torch.Tensor) for t in ts):
            raise TypeError("FusedRNN holds torch tensors; use "
                            "FusedRNN.from_numpy for numpy arrays")
        if len({t.device for t in ts}) > 1:
            raise ValueError("FusedRNN: wX, wS, b and s0 must be on one "
                             "device")

    @property
    def device(self) -> torch.device:
        return self.wX.device

    @classmethod
    def from_recurrent(cls, net, act: str = "logistic",
                       precision: str = "default") -> "FusedRNN":
        """From a single-layer ``fully_connected`` RecurrentNetwork (params
        ``(wS, wX, b)``, one state), as float32 on the net's device."""
        wS, wX, b = (p.to(torch.float32) for p in net.params)
        (s0,) = net.states
        return cls(wX, wS, b, s0.to(torch.float32), act, precision)

    @classmethod
    def from_numpy(cls, wX: Any, wS: Any, b: Any, s0: Any,
                   act: str = "logistic", precision: str = "default",
                   impl: str = "xla",
                   device: "str | torch.device" = "cuda") -> "FusedRNN":
        """From host arrays — e.g. the JAX package's FusedRNN parameters as
        numpy arrays — onto ``device``, keeping each array's dtype."""
        def t(a):
            return torch.tensor(np.asarray(a), device=device)  # a copy

        return cls(t(wX), t(wS), t(b), t(s0), act, precision, impl)

    def _scan(self, wX, wS, b, s0, xs):
        """xs (n, i) from s0 (o,) -> (ys (n, o) pre-activations, final
        state): one ``fused_rnn_seq`` call (``impl="pallas"``) or a loop of
        the plain cell (``impl="xla"``)."""
        if self.impl == "pallas":
            ys, s = fused_rnn_seq(xs[:, None], s0[None], wX, wS, b, self.act,
                                  self.precision)
            return ys[:, 0], s[0]
        act = _act_fn(self.act)
        s, ys = s0, []
        for t in range(xs.shape[0]):
            z = wX @ xs[t] + wS @ s + b
            s = act(z)
            ys.append(z)
        return torch.stack(ys), s

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.wX.dtype, device=self.device)

    def seq_forward(self, xs) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs: (n, i) -> (ys: (n, o) pre-activations, final state (o,))."""
        with torch.no_grad():
            return self._scan(self.wX, self.wS, self.b, self.s0,
                              self._as(xs))

    def train(self, rate_state: float, rate_param: float, xs, targets
              ) -> Tuple[float, "FusedRNN"]:
        """One SGD step on the summed squared sequence loss
        ``sum((targets - ys) ** 2)`` by autograd through the steps, with the
        reference's dual state/param rates (``trainNetwork'``).  Returns
        (loss before the step, the updated model)."""
        xs, tg = self._as(xs), self._as(targets)
        ps = [p.detach().requires_grad_()
              for p in (self.wX, self.wS, self.b, self.s0)]
        with torch.enable_grad():
            ys, _ = self._scan(*ps, xs)
            v = ((tg - ys) ** 2).sum()
            g = torch.autograd.grad(v, ps)
        with torch.no_grad():
            wX, wS, b = (p - rate_param * gp for p, gp in zip(ps[:3], g[:3]))
            s0 = ps[3] - rate_state * g[3]
        return float(v.detach()), FusedRNN(wX, wS, b, s0, self.act,
                                           self.precision, impl=self.impl)
