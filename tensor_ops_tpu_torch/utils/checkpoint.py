"""Checkpoint / resume, in the JAX package's npz format.

Parameters go to a single ``.npz`` with a small JSON manifest stored as the
``__meta__`` array of utf-8 bytes (``tensor_ops_tpu/utils/checkpoint.py``),
so each package reads the other's files: a ``save_network`` checkpoint
written by either one serves from both.  Tensors are moved to the host on
save; bf16 tensors are written as float32 (numpy has no bf16, and the
widening is exact).

This module carries the feed-forward, recurrent, ``FusedMLP``,
``QuantizedMLP``, ``FusedAutoencoder`` and ``PipelineMLP`` formats, and the train-state
format that ``fit`` and ``fit_sequences`` write beside their servable
checkpoints (parameters, optimizer state, the Polyak average and the global
step: a ``.state`` file of either package resumes in the other), with asynchronous saves for the training loop; int8
codes stay int8 in the file.  Loaders place the model on the card unless the
caller names another device.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _to_numpy(v: Any) -> np.ndarray:
    """A host copy of ``v``: a tensor on the CPU is copied too (``.cpu()``
    returns it unchanged, and ``.numpy()`` would share its memory), so an
    asynchronous write never reads memory the caller may reuse."""
    import torch

    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return (v.numpy().copy() if v.device.type == "cpu"
                else v.cpu().numpy())
    return np.array(v)


def save_arrays(path: str, arrays: Dict[str, Any], meta: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np_arrays = {k: _to_numpy(v) for k, v in arrays.items()}
    np_arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    # write to a sibling temp file and os.replace() into place: a crash
    # mid-write must never leave a torn checkpoint where a good one stood
    # (rename is atomic on POSIX).  Writing through a file handle also
    # stops np.savez appending ".npz" to the path.
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **np_arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


_ASYNC_POOL = None
_ASYNC_LOCK = threading.Lock()


def save_arrays_async(path: str, arrays: Dict[str, Any],
                      meta: Optional[dict] = None):
    """Checkpoint without blocking the training loop: tensors are copied
    to the host synchronously (cheap), the file write happens on a
    background thread.  Returns a Future; call ``.result()`` to join."""
    global _ASYNC_POOL
    with _ASYNC_LOCK:
        if _ASYNC_POOL is None:
            _ASYNC_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt")
    host_arrays = {k: _to_numpy(v) for k, v in arrays.items()}
    return _ASYNC_POOL.submit(save_arrays, path, host_arrays, meta)


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


def load_meta(path: str) -> dict:
    """Just the JSON manifest of a checkpoint file; array payloads are
    not materialized."""
    with np.load(path) as z:
        return (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z.files else {})


def _network_payload(net, extra_meta: Optional[dict]) -> Tuple[dict, dict]:
    arrays = {f"param_{i}": p for i, p in enumerate(net.params)}
    meta = {
        "kind": "feedforward",
        "param_stack": [list(s) for s in net.param_stack],
        "in_shape": list(net.in_shape),
        "out_shape": list(net.out_shape),
    }
    if net.act_names is not None:
        # activation names travel with the weights so a serving process
        # can rebuild the exact graph without out-of-band layer flags
        meta["acts"] = list(net.act_names)
    meta.update(extra_meta or {})
    return arrays, meta


def save_network(path: str, net, extra_meta: Optional[dict] = None) -> None:
    """Save a feed-forward Network's params (+ activation names)."""
    save_arrays(path, *_network_payload(net, extra_meta))


def save_network_async(path: str, net, extra_meta: Optional[dict] = None):
    """``save_network`` with the file write on the checkpoint thread
    (tensors are copied to the host synchronously).  Returns a Future."""
    return save_arrays_async(path, *_network_payload(net, extra_meta))


def network_from_arrays(arrays: Dict[str, np.ndarray], meta: dict, net, be) -> Any:
    """Rebuild a Network from already-loaded checkpoint contents: the
    op graph is ``net``'s (code), the parameters are the arrays, moved to
    ``be``'s dtype and device.  Raises if a shape or the recorded
    activation names differ from ``net``'s."""
    from ..models.feedforward import Network
    from ..ops.shapes import ShapeError

    params = tuple(
        be.asarray(arrays[f"param_{i}"]) for i in range(len(net.params))
    )
    for p, s in zip(params, net.param_stack):
        if tuple(p.shape) != tuple(s):
            raise ShapeError(
                f"checkpoint param shape {tuple(p.shape)} != expected {tuple(s)}"
            )
    saved_acts = meta.get("acts")
    if (saved_acts is not None and net.act_names is not None
            and tuple(saved_acts) != tuple(net.act_names)):
        raise ValueError(
            f"checkpoint activations {tuple(saved_acts)} != the rebuilt "
            f"graph's {tuple(net.act_names)} — reconstruct the network "
            f"with the checkpoint's activations")
    return Network(net.op, params, net.act_names)


def load_network(path: str, net, be) -> Any:
    """Restore params into an architecture-compatible Network."""
    arrays, meta = load_arrays(path)
    return network_from_arrays(arrays, meta, net, be)


def save_fused(path: str, model, extra_meta: Optional[dict] = None) -> None:
    """Save a FusedMLP (weights, biases, activation names)."""
    arrays = {f"w_{i}": w for i, w in enumerate(model.weights)}
    arrays.update({f"b_{i}": b for i, b in enumerate(model.biases)})
    meta = {
        "kind": "fused_mlp",
        "acts": list(model.acts),
        "softmax_out": bool(model.softmax_out),
        "precision": model.precision,
        "loss_kind": model.loss_kind,
    }
    meta.update(extra_meta or {})
    save_arrays(path, arrays, meta)


def _fused_from_arrays(arrays, meta, device="cuda"):
    from ..models.fast import FusedMLP

    n = sum(1 for k in arrays if k.startswith("w_"))
    ws = tuple(arrays[f"w_{i}"] for i in range(n))
    bs = tuple(arrays[f"b_{i}"] for i in range(n))
    return FusedMLP.from_numpy(ws, bs, tuple(meta["acts"]),
                               meta["softmax_out"], device=device,
                               precision=meta.get("precision", "default"),
                               loss_kind=meta.get("loss_kind", "ce"))


def load_fused(path: str, device="cuda"):
    arrays, meta = load_arrays(path)
    return _fused_from_arrays(arrays, meta, device)


def _tree_leaves(tree) -> list:
    """Flatten a nested tuple/list/NamedTuple/dict tree of array/scalar
    leaves (every optimizer state of ``optim.py``) in the JAX package's
    order: ``None`` is an empty subtree, dicts go in sorted-key order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        out = []
        for t in tree:
            out.extend(_tree_leaves(t))
        return out
    return [tree]


def _tree_unflatten(template, leaves_iter):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _tree_unflatten(template[k], leaves_iter)
                for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        vals = [_tree_unflatten(t, leaves_iter) for t in template]
        if hasattr(template, "_fields"):  # NamedTuple states
            return type(template)(*vals)
        return type(template)(vals)
    leaf = next(leaves_iter)
    if isinstance(template, bool):
        return bool(leaf)
    if isinstance(template, int):
        return int(leaf)  # e.g. adam's step count
    if isinstance(template, float):
        return float(leaf)
    if isinstance(template, np.ndarray):
        return np.asarray(leaf, dtype=template.dtype)
    import torch

    from ..parallel.mesh import Remote, Sharded, place

    if isinstance(template, Sharded):
        # a leaf of a mesh's state resumes on its template's spec, in pinned
        # host memory again where the template was offloaded (the shards
        # placed on the ranks' cards come back to the host)
        out = place(leaf, template.spec, template.mesh, template.dtype)
        if template.local.device.type == "cpu" and _pinned(template):
            out.shards = [x if isinstance(x, Remote) else
                          x.cpu().pin_memory() for x in out.shards]
        return out
    if isinstance(template, torch.Tensor):
        out = torch.as_tensor(leaf, dtype=template.dtype,
                              device=template.device)
        return out.pin_memory() if _pinned(template) else out
    return leaf


def _pinned(template) -> bool:
    """Whether a template leaf (its first shard) lies in pinned host memory
    (``offload_opt_state``)."""
    x = getattr(template, "local", template)
    return x.device.type == "cpu" and x.is_pinned()


def _train_state_payload(params, opt_state, step: int, opt_key,
                         extra_meta: Optional[dict],
                         ema=None) -> Tuple[dict, dict]:
    arrays = {f"p_{i}": p for i, p in enumerate(params)}
    leaves = _tree_leaves(opt_state)
    arrays.update({f"o_{i}": l for i, l in enumerate(leaves)})
    meta = {"kind": "train_state", "step": int(step),
            "n_params": len(params), "n_opt_leaves": len(leaves)}
    if ema is not None:
        # the Polyak average lives in the same file as the parameters it
        # averages, so one atomic write keeps the pair consistent
        arrays.update({f"e_{i}": l for i, l in enumerate(ema)})
        meta["n_ema_leaves"] = len(ema)
    if opt_key is not None:
        # structural identity of the update rule (Optimizer.struct_key):
        # resuming under other hyperparameters would silently reinterpret
        # the moments, so it is recorded for load-time validation
        meta["opt_key"] = json.dumps(opt_key)
    meta.update(extra_meta or {})
    return arrays, meta


def save_train_state(path: str, params, opt_state, step: int,
                     extra_meta: Optional[dict] = None, opt_key=None,
                     ema=None) -> None:
    """Full training-state checkpoint: parameters AND optimizer state
    AND the global step, what exact resume needs (``fit(resume=True)``).
    ``opt_key`` (``opt.struct_key()``) is stored so that resume can refuse
    a changed optimizer or hyperparameters; ``ema`` (leaves matching
    ``params``) stores the Polyak average in the same atomic write."""
    save_arrays(path, *_train_state_payload(params, opt_state, step,
                                            opt_key, extra_meta, ema))


def save_train_state_async(path: str, params, opt_state, step: int,
                           extra_meta: Optional[dict] = None, opt_key=None,
                           ema=None):
    """``save_train_state`` with the file write off the training thread
    (tensors are copied to the host synchronously).  Returns a Future."""
    return save_arrays_async(path, *_train_state_payload(
        params, opt_state, step, opt_key, extra_meta, ema))


def load_train_state(path: str, opt_state_template, opt_key=None,
                     expect_meta: Optional[dict] = None,
                     with_ema: bool = False):
    """``(params, opt_state, step)``, or with ``with_ema=True``
    ``(params, opt_state, step, ema)`` where ``ema`` is None when the
    saving run kept no Polyak average: the parameters and EMA leaves as
    host arrays, the optimizer leaves restored into the structure of
    ``opt_state_template`` (``opt.init(params)``), each array leaf with the
    template leaf's dtype and device and each scalar of its Python type.
    A stored ``opt_key`` that differs from the caller's raises, and so
    does a key of ``expect_meta`` present in both the file and the
    expectation with another value (``fit``'s ``layout``)."""
    arrays, meta = load_arrays(path)
    if meta.get("kind") != "train_state":
        raise ValueError(f"{path} is not a train_state checkpoint")
    for key, want in (expect_meta or {}).items():
        have = meta.get(key)
        if have is not None and have != want:
            raise ValueError(
                f"train-state mismatch on {key!r}: checkpoint was saved "
                f"with {have!r}, resume requested {want!r} — resume with "
                f"the same configuration")
    saved_key = meta.get("opt_key")
    if saved_key is not None and opt_key is not None:
        if saved_key != json.dumps(opt_key):
            raise ValueError(
                f"optimizer mismatch: checkpoint was saved with "
                f"{saved_key}, resume requested {json.dumps(opt_key)} — "
                f"resume with the same optimizer/hyperparameters")
    params = tuple(arrays[f"p_{i}"] for i in range(meta["n_params"]))
    n = meta["n_opt_leaves"]
    leaves = [arrays[f"o_{i}"] for i in range(n)]
    n_expected = len(_tree_leaves(opt_state_template))
    if n_expected != n:
        raise ValueError(
            f"optimizer state mismatch: checkpoint has {n} leaves, the "
            f"current optimizer expects {n_expected} — resume "
            f"with the same optimizer/hyperparameters")
    opt_state = _tree_unflatten(opt_state_template, iter(leaves))
    if not with_ema:
        return params, opt_state, int(meta["step"])
    n_e = meta.get("n_ema_leaves")
    ema = (tuple(arrays[f"e_{i}"] for i in range(n_e))
           if n_e is not None else None)
    return params, opt_state, int(meta["step"]), ema


def save_autoencoder(path: str, model, extra_meta: Optional[dict] = None
                     ) -> None:
    """Save a FusedAutoencoder: the stacked encoder+decoder ``FusedMLP`` and
    the encoder/decoder split point."""
    meta = {"kind": "fused_autoencoder", "n_enc": int(model.n_enc)}
    meta.update(extra_meta or {})
    save_fused(path, model.mlp, meta)


def load_autoencoder(path: str, device="cuda"):
    from ..models.fast import FusedAutoencoder

    arrays, meta = load_arrays(path)
    return FusedAutoencoder(_fused_from_arrays(arrays, meta, device),
                            int(meta["n_enc"]))


def save_quantized(path: str, model, extra_meta: Optional[dict] = None) -> None:
    """Save a QuantizedMLP (int8 codes, f32 scales and biases, activation
    names, mode) under the JAX package's keys: ``wq_i``, ``s_i``, ``b_i``."""
    arrays = {f"wq_{i}": q for i, q in enumerate(model.wqs)}
    arrays.update({f"s_{i}": s for i, s in enumerate(model.scales)})
    arrays.update({f"b_{i}": b for i, b in enumerate(model.biases)})
    meta = {
        "kind": "quantized_mlp",
        "acts": list(model.acts),
        "softmax_out": bool(model.softmax_out),
        "mode": model.mode,
    }
    meta.update(extra_meta or {})
    save_arrays(path, arrays, meta)


def _quantized_from_arrays(arrays, meta, device="cuda"):
    from ..models.fast import QuantizedMLP

    n = sum(1 for k in arrays if k.startswith("wq_"))
    return QuantizedMLP.from_numpy(
        [arrays[f"wq_{i}"] for i in range(n)],
        [arrays[f"s_{i}"] for i in range(n)],
        [arrays[f"b_{i}"] for i in range(n)], tuple(meta["acts"]),
        meta["softmax_out"], meta.get("mode", "w8a8"), device=device)


def load_quantized(path: str, device="cuda"):
    arrays, meta = load_arrays(path)
    return _quantized_from_arrays(arrays, meta, device)


def save_pipeline(path: str, model, extra_meta: Optional[dict] = None) -> None:
    """Save a ``PipelineMLP`` (the JAX package's format: its six arrays,
    whole; a leaf sharded on a mesh is gathered to the host)."""
    arrays = {
        "w_in": model.w_in, "b_in": model.b_in,
        "stage_ws": model.stage_ws, "stage_bs": model.stage_bs,
        "w_out": model.w_out, "b_out": model.b_out,
    }
    meta = {"kind": "pipeline_mlp"}
    meta.update(extra_meta or {})
    save_arrays(path, arrays, meta)


def load_pipeline(path: str, device="cuda"):
    """A ``PipelineMLP`` saved by either package, on ``device``."""
    from ..parallel.pipeline import PipelineMLP

    arrays, _ = load_arrays(path)
    return PipelineMLP.from_arrays(
        *(arrays[k] for k in ("w_in", "b_in", "stage_ws", "stage_bs",
                              "w_out", "b_out")), device=device)


def _recurrent_payload(net, extra_meta: Optional[dict]) -> Tuple[dict, dict]:
    arrays = {f"param_{i}": p for i, p in enumerate(net.params)}
    arrays.update({f"state_{i}": s for i, s in enumerate(net.states)})
    meta = {"kind": "recurrent", "n_states": len(net.states)}
    if getattr(net, "arch", None) is not None:
        # gen_net's architecture record: lets serving rebuild the exact
        # graph (sizes + activations) with no out-of-band flags
        meta["arch"] = net.arch
    meta.update(extra_meta or {})
    return arrays, meta


def save_recurrent(path: str, net, extra_meta: Optional[dict] = None) -> None:
    """Save a RecurrentNetwork's params, states and ``arch`` record."""
    save_arrays(path, *_recurrent_payload(net, extra_meta))


def save_recurrent_async(path: str, net, extra_meta: Optional[dict] = None):
    """``save_recurrent`` with the file write on the checkpoint thread."""
    return save_arrays_async(path, *_recurrent_payload(net, extra_meta))


def recurrent_from_arrays(arrays, meta, net, be) -> Any:
    """Rebuild a RecurrentNetwork from already-loaded checkpoint contents,
    or carry a JAX net's weights across (its ``params``/``states`` as numpy
    arrays under the same keys): the op graph is ``net``'s, the states and
    params are the arrays on ``be``'s dtype and device.  Counts AND shapes
    are validated against the template (a wrong architecture raises a clean
    error, never a KeyError)."""
    from ..models.recurrent import RecurrentNetwork
    from ..ops.shapes import ShapeError

    n_p = sum(1 for k in arrays if k.startswith("param_"))
    n_s = sum(1 for k in arrays if k.startswith("state_"))
    if n_p != len(net.params) or n_s != len(net.states):
        raise ValueError(
            f"recurrent checkpoint has {n_p} params / {n_s} states but "
            f"the template network expects {len(net.params)} / "
            f"{len(net.states)} — rebuild with the architecture it was "
            f"trained with" + (f" (stored arch: {meta['arch']})"
                               if "arch" in meta else ""))
    params = tuple(be.asarray(arrays[f"param_{i}"]) for i in range(n_p))
    states = tuple(be.asarray(arrays[f"state_{i}"]) for i in range(n_s))
    for got, want, what in (
        (params, net.param_stack, "param"),
        (states, net.state_stack, "state"),
    ):
        for i, (a, sh) in enumerate(zip(got, want)):
            if tuple(a.shape) != tuple(sh):
                raise ShapeError(
                    f"recurrent checkpoint {what} {i} has shape "
                    f"{tuple(a.shape)}, expected {tuple(sh)}")
    return RecurrentNetwork(net.op, states, params,
                            meta.get("arch", net.arch))


def load_recurrent(path: str, net, be) -> Any:
    """Restore states and params into an architecture-compatible
    RecurrentNetwork ``net`` on ``be``'s device."""
    arrays, meta = load_arrays(path)
    return recurrent_from_arrays(arrays, meta, net, be)
