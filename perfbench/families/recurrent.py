"""The program side of a recurrent configuration: its network built from
the configuration's layers with the benchmark's own leaves (the initial
states first), its loss, and its training loop ``fit_sequences``; and the
sequences of each of its steps, worked out again without the program
(``batch_rows``)."""

from __future__ import annotations


def build(cfg, be, leaves):
    """A ``RecurrentNetwork`` of ``cfg``'s layers holding ``leaves`` (the
    graph from the recurrent ``gen_net``, whose own draws are replaced)."""
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import RecurrentNetwork, activation_by_name
    from tensor_ops_tpu_torch.models.recurrent import gen_net

    act = activation_by_name
    net = gen_net(be, cfg["in"], cfg["out"][0],
                  [(h, act(a), act(s) if s else None)
                   for h, a, s in cfg["hidden"]],
                  act(cfg["out"][1]), None, Rng(be, seed=0))
    k = len(net.states)
    return RecurrentNetwork(net.op, tuple(leaves[:k]), tuple(leaves[k:]),
                            net.arch)


def loss(cfg):
    from tensor_ops_tpu_torch import models

    return getattr(models, cfg["loss"])(cfg["out"][0])


def leaves(rnet):
    return list(rnet.states) + list(rnet.params)


def steps_per_epoch(rows: int, batch: int) -> int:
    """``fit_sequences``' epoch: whole batches, the ragged tail dropped."""
    return rows // batch


def rows_of_step(step: int, rows: int, batch: int) -> int:
    return batch


def batch_rows(seed: int, rows: int, batch: int, steps: int):
    """The sequence indices of ``fit_sequences``' global steps ``0 ..
    steps - 1``: each epoch's order (``perfbench.shuffle.seq_epochs``) cut
    into whole batches."""
    from perfbench.shuffle import seq_epochs

    spe = steps_per_epoch(rows, batch)
    orders = seq_epochs(seed, -(-steps // spe), rows)
    return [orders[s // spe][(s % spe) * batch:(s % spe + 1) * batch]
            for s in range(steps)]


def rate_of(opt: dict) -> float:
    """The rate ``lr_schedule`` hands back each step: the param rate, which
    leaves the state rate's ratio to it, and so both rates, unchanged."""
    if opt["kind"] != "dual_sgd":
        raise ValueError(f"fit_sequences is driven with dual_sgd here, not "
                         f"{opt['kind']!r}")
    return opt["rate_param"]


def fit(rnet, loss_op, be, data, opt: dict, **kw):
    """``fit_sequences`` on ``data["X"]`` (N, n, in) with targets
    ``data["Y"]``, host float32 arrays, by the dual-rate SGD of ``opt``."""
    from tensor_ops_tpu_torch.models import fit_sequences

    rate_of(opt)
    return fit_sequences(rnet, loss_op, be, data["X"], data["Y"],
                         rate_state=opt["rate_state"],
                         rate_param=opt["rate_param"], **kw)
