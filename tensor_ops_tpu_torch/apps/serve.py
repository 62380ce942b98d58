"""tensor-ops-serve on PyTorch: serve a trained network checkpoint.

The port of ``apps/serve.py``, with the same flags plus ``--device``: load
a ``feedforward`` (``save_network``), ``fused_mlp`` (``save_fused``),
``quantized_mlp`` (``save_quantized``) or ``recurrent``
(``save_recurrent``) checkpoint written by either package, optionally
quantize a feed-forward model to int8 at load (``--int8``, w8a8), warm the
bucketed ``Predictor`` (``SequencePredictor`` for a recurrent model), then
answer prediction requests from an .npy/.npz/CSV file (whole sequences,
``(B, n, in_dim)``, for a recurrent model) or run a latency self-benchmark.
A ``quantized_mlp`` checkpoint serves in the mode it was saved with (w8 or
w8a8).  Everything runs on ``--device`` (default cuda).

Examples:
    python -m tensor_ops_tpu_torch.apps.serve ckpt.npz --bench
    python -m tensor_ops_tpu_torch.apps.serve ckpt.npz -i batch.npy --probs
    python -m tensor_ops_tpu_torch.apps.serve ckpt.npz --int8 --bench
    python -m tensor_ops_tpu_torch.apps.serve rnn.npz -i seqs.npy --probs
    python -m tensor_ops_tpu_torch.apps.serve rnn.npz --bench --seq-len 64
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..backend.rng import Rng
from ..backend.torch_backend import TorchBackend
from ..models import activation_by_name, gen_net
from ..models.fast import FusedMLP, QuantizedMLP
from ..models.serve import Predictor, SequencePredictor
from ..ops.shapes import ShapeError
from ..utils.checkpoint import (_fused_from_arrays, _quantized_from_arrays,
                                load_arrays, network_from_arrays,
                                recurrent_from_arrays)


def load_recurrent_model(payload, layers, in_dim: int, out_dim: int,
                         act: str, state_act: str, device: torch.device):
    """Rebuild the recurrent template on ``device`` — from the checkpoint's
    stored ``arch`` metadata when present (no flags needed), else from the
    architecture flags — and load the checkpoint's states and params into
    it (count- and shape-validated).  Returns ``(network, backend)``."""
    from ..models.recurrent import gen_net as gen_rnet

    be = TorchBackend(torch.float32, device)
    arrays, meta = payload
    arch = meta.get("arch")
    if arch is not None:
        hidden = [
            (h, activation_by_name(a),
             activation_by_name(s) if s is not None else None)
            for h, a, s in zip(arch["sizes"], arch["acts"],
                               arch["state_acts"])
        ]
        out_act = activation_by_name(arch["acts"][-1])
        s_last = arch["state_acts"][-1]
        out_sact = activation_by_name(s_last) if s_last is not None else None
        rnet = gen_rnet(be, arch["in"], arch["out"], hidden, out_act,
                        out_sact, Rng(be, seed=0))
    else:

        def _sact():
            return (None if state_act == "none"
                    else activation_by_name(state_act))

        rnet = gen_rnet(
            be, in_dim, out_dim,
            [(h, activation_by_name(act), _sact()) for h in layers],
            activation_by_name(act), _sact(), Rng(be, seed=0))
    return recurrent_from_arrays(arrays, meta, rnet, be), be


def load_model(payload, layers, in_dim: int, out_dim: int,
               act: str, device: torch.device, int8: bool = False):
    """Dispatch on the checkpoint's ``kind`` metadata; with ``int8`` a
    float model is quantized to a w8a8 ``QuantizedMLP`` on ``device``.
    Bare Network checkpoints rebuild the op graph from the activation names
    stored in the checkpoint; older checkpoints without them fall back to
    the ``--act`` flag for hidden layers + softmax out."""
    arrays, meta = payload
    kind = meta.get("kind", "network")
    if kind == "quantized_mlp":
        return _quantized_from_arrays(arrays, meta, device)
    if kind == "fused_mlp":
        fm = _fused_from_arrays(arrays, meta, device)
        return QuantizedMLP.from_fused(fm) if int8 else fm
    if kind not in ("feedforward", "network"):
        raise SystemExit(f"checkpoint kind {kind!r} is not a feed-forward "
                         f"model")
    be = TorchBackend(torch.float32, device)
    saved_acts = meta.get("acts")
    if saved_acts is not None:
        if len(saved_acts) != len(layers) + 1:
            raise SystemExit(
                f"checkpoint has {len(saved_acts)} activations but "
                f"--layers {','.join(map(str, layers))} implies "
                f"{len(layers) + 1} — pass the architecture it was "
                f"trained with")
        hidden = [activation_by_name(a) for a in saved_acts[:-1]]
        out_act = activation_by_name(saved_acts[-1])
    else:
        hidden = [activation_by_name(act) for _ in layers]
        out_act = activation_by_name("softmax")
    net = gen_net(be, in_dim, out_dim,
                  list(zip(layers, hidden)), out_act, Rng(be, seed=0))
    net = network_from_arrays(arrays, meta, net, be)
    fm = FusedMLP.from_network(net)
    return QuantizedMLP.from_fused(fm) if int8 else fm


def _load_array_file(path: str) -> np.ndarray:
    """.npy / .npz (first array) / CSV -> float32 ndarray."""
    if path.endswith(".npy"):
        x = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            x = z[list(z.files)[0]]
    else:  # CSV
        x = np.loadtxt(path, delimiter=",")
    return np.asarray(x, dtype=np.float32)


def read_batch(path: str, in_dim: int) -> np.ndarray:
    x = _load_array_file(path)
    if x.ndim == 1:
        # 1-D is ambiguous: N samples of one feature vs one sample of N
        # features — the model dim decides
        x = x.reshape(-1, 1) if in_dim == 1 else x.reshape(1, -1)
    if x.shape[1] != in_dim:
        raise SystemExit(f"input dim {x.shape[1]} != model dim {in_dim}")
    return x


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="tensor-ops-serve",
        description="Serve a trained tensor-ops checkpoint on PyTorch")
    p.add_argument("checkpoint", help=".npz checkpoint path")
    p.add_argument("-l", "--layers", type=str, default="300,100",
                   help="Hidden sizes for bare Network checkpoints "
                        "(default: 300,100)")
    p.add_argument("--in-dim", type=int, default=784)
    p.add_argument("--out-dim", type=int, default=10)
    p.add_argument("--int8", action="store_true",
                   help="Quantize weights to int8 at load (w8a8: int8 x "
                        "int8 -> int32 kernels)")
    p.add_argument("--bf16", action="store_true",
                   help="Store weights in bfloat16 (half the weight memory)")
    p.add_argument("--act", type=str, default="logistic",
                   choices=("logistic", "relu", "tanh"),
                   help="Hidden activation for OLD bare-Network "
                        "checkpoints without stored activation names "
                        "(new checkpoints carry them); also the "
                        "recurrent template's activation")
    p.add_argument("--state-act", type=str, default="logistic",
                   choices=("logistic", "relu", "tanh", "none"),
                   help="Recurrent checkpoints without a stored "
                        "architecture: the state activation ('none' = "
                        "stateless layers)")
    p.add_argument("--seq-len", type=int, default=16,
                   help="Recurrent --bench: sequence length to time")
    p.add_argument("-i", "--input", type=str, default=None,
                   help="Batch file (.npy/.npz/CSV) to predict")
    p.add_argument("--probs", action="store_true",
                   help="Print class probabilities instead of argmax")
    p.add_argument("--buckets", type=str, default="8,64,512",
                   help="Padding buckets (served batch shapes)")
    p.add_argument("--bench", action="store_true",
                   help="Warm up, run a latency self-benchmark, print JSON")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device to serve on (default: cuda)")
    args = p.parse_args(argv)

    layers = [int(x) for x in args.layers.split(",") if x]
    buckets = tuple(int(x) for x in args.buckets.split(",") if x)
    if args.int8 and args.bf16:
        p.error("--int8 and --bf16 are mutually exclusive")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {args.device}: CUDA is not available")

    payload = load_arrays(args.checkpoint)
    if payload[1].get("kind") == "recurrent":
        if args.int8 or args.bf16:
            p.error("--int8/--bf16 do not apply to recurrent checkpoints")
        return serve_recurrent(p, args, layers, buckets, payload, device)
    model = load_model(payload, layers, args.in_dim, args.out_dim,
                       args.act, device, int8=args.int8)
    if args.bf16 and isinstance(model, QuantizedMLP):
        p.error("--bf16 does not apply to an int8 (quantized_mlp) "
                "checkpoint — it is already the smaller artifact")
    pred = Predictor(model, buckets=buckets,
                     dtype="bf16" if args.bf16 else None)
    print(f"Serving {type(model).__name__} from {args.checkpoint} "
          f"on {device} (buckets {buckets})")

    if args.bench:
        pred.warmup()
        r = np.random.default_rng(0)
        for b in buckets:
            x = r.uniform(0, 1, size=(b, args.in_dim)).astype(np.float32)
            for _ in range(5):
                pred.predict(x)
        print(json.dumps({"latency": pred.latency()}))
        return

    if args.input:
        x = read_batch(args.input, args.in_dim)
        out = pred.predict(x) if args.probs else pred.predict_class(x)
        for row in np.atleast_1d(out):
            if args.probs:
                print(",".join(f"{v:.6f}" for v in np.atleast_1d(row)))
            else:
                print(int(row))
        return

    p.error("nothing to do: pass --bench or -i BATCH")


def serve_recurrent(p, args, layers, buckets, payload, device):
    """Recurrent-checkpoint serving: whole sequences through the
    ``SequencePredictor`` (input: a ``(B, n, in_dim)`` .npy/.npz; output:
    one line per sequence — the final timestep's outputs, or the full
    per-timestep trajectory with ``--probs``)."""
    try:
        rnet, be = load_recurrent_model(
            payload, layers, args.in_dim, args.out_dim, args.act,
            args.state_act, device)
    except (ValueError, KeyError, ShapeError) as e:
        raise SystemExit(f"error: cannot rebuild the recurrent network "
                         f"from this checkpoint: {e!r}")
    sp = SequencePredictor(rnet, be, buckets=buckets)
    print(f"Serving RecurrentNetwork from {args.checkpoint} "
          f"on {device} (buckets {buckets})")
    in_dim = rnet.in_shape[0]

    if args.bench:
        sp.warmup(lengths=(args.seq_len,))
        r = np.random.default_rng(0)
        for b in buckets:
            xs = r.uniform(0, 1, size=(b, args.seq_len, in_dim)) \
                .astype(np.float32)
            for _ in range(5):
                sp.predict(xs)
        print(json.dumps({"latency": sp.latency()}))
        return

    if args.input:
        if not args.input.endswith((".npy", ".npz")):
            raise SystemExit("recurrent serving needs a (B, n, in_dim) "
                             ".npy/.npz of sequences")
        xs = _load_array_file(args.input)
        if xs.ndim == 2:
            xs = xs[None]
        if xs.ndim != 3 or xs.shape[2] != in_dim:
            raise SystemExit(f"expected (B, n, {in_dim}) sequences, "
                             f"got {xs.shape}")
        out = sp.predict(xs)
        for seq_out in out:
            if args.probs:
                # full trajectory: one line per timestep, blank between
                # sequences
                for t in range(seq_out.shape[0]):
                    print(",".join(f"{v:.6f}"
                                   for v in np.atleast_1d(seq_out[t])))
                print()
            else:
                print(",".join(f"{v:.6f}"
                               for v in np.atleast_1d(seq_out[-1])))
        return

    p.error("nothing to do: pass --bench or -i SEQS")


if __name__ == "__main__":
    main()
