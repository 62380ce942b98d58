"""The program side of a feed-forward configuration: its network built
from the configuration's layers with the benchmark's own leaves, its loss,
and its training loop ``fit``; and the rows of each of ``fit``'s steps,
worked out again without the program (``batch_rows``)."""

from __future__ import annotations


def build(cfg, be, leaves):
    """A ``Network`` of ``cfg``'s layers holding ``leaves`` (the graph from
    ``gen_net``, whose own draws are replaced)."""
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import Network, activation_by_name, gen_net

    act = activation_by_name
    net = gen_net(be, cfg["in"], cfg["out"][0],
                  [(h, act(a)) for h, a in cfg["hidden"]],
                  act(cfg["out"][1]), Rng(be, seed=0))
    return Network(net.op, tuple(leaves), net.act_names)


def loss(cfg):
    from tensor_ops_tpu_torch import models

    return getattr(models, cfg["loss"])(cfg["out"][0])


def leaves(net):
    return list(net.params)


def steps_per_epoch(rows: int, batch: int) -> int:
    """``fit``'s epoch: every row once, the last batch ragged."""
    return -(-rows // batch)


def rows_of_step(step: int, rows: int, batch: int) -> int:
    """The rows of global step ``step`` (0-based)."""
    last = step % steps_per_epoch(rows, batch) == steps_per_epoch(rows, batch) - 1
    return rows % batch if last and rows % batch else batch


def batch_rows(seed: int, rows: int, batch: int, steps: int):
    """The row indices of ``fit``'s global steps ``0 .. steps - 1``: each
    epoch's loader order (``perfbench.shuffle.native_epochs``) cut into
    batches, the last one ragged."""
    from perfbench.shuffle import native_epochs

    spe = steps_per_epoch(rows, batch)
    orders = native_epochs(seed, -(-steps // spe), rows)
    return [orders[s // spe][(s % spe) * batch:(s % spe + 1) * batch]
            for s in range(steps)]


def optimizer(opt: dict):
    """The program's optimizer for the plain update ``opt`` names, and the
    keyword arguments of its rate."""
    from tensor_ops_tpu_torch.models import adam

    if opt["kind"] == "adam":
        return adam(opt["b1"], opt["b2"], opt["eps"]), {"lr": opt["lr"]}
    if opt["kind"] == "sgd":
        return None, {"lr": opt["rate"]}
    raise ValueError(f"fit takes no {opt['kind']!r} update")


def rate_of(opt: dict) -> float:
    """The rate ``lr_schedule`` hands back each step (the constant rate)."""
    return opt["lr"] if opt["kind"] == "adam" else opt["rate"]


def fit(net, loss_op, be, data, opt: dict, **kw):
    """``fit`` on the rows ``data["X"]`` with targets ``data["Y"]`` (host
    float32 arrays), ``val=(Xv, labels)`` when ``data`` has them."""
    from tensor_ops_tpu_torch.models import fit as fit_

    optim, rate = optimizer(opt)
    if "Xv" in data:
        kw["val"] = (data["Xv"], data["Lv"])
    return fit_(net, loss_op, be, data["X"], data["Y"], optimizer=optim,
                **rate, **kw)
