"""The port's mesh planner (``tensor_ops_tpu_torch.parallel.plan``) against
the JAX package's: the same nets (the port's graph holding the JAX
package's parameters) give the same plans, entry for entry, in the same
order, and the JAX package's own assertions hold on the port's plans: they
rank factorizations by the analytic quantities the partitioners use,
exclude what ``fit`` would refuse, and flag idle axes."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import adam as j_adam
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.parallel import plan as JPL
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import adam as t_adam
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.parallel import describe_plans, plan_meshes
from tensor_ops_tpu_torch.utils.checkpoint import network_from_arrays
from torch_threads import one_torch_thread  # noqa: F401

JNB = T.NumpyBackend()
TB = TorchBackend(torch.float64, "cpu")


def nets(i, o, hidden, seed):
    """``(jax net, port net)``: the logistic chain with a softmax head drawn
    by the JAX package from ``seed``, the port's graph holding its
    parameters (f64 on both sides)."""
    jn = j_gen_net(JNB, i, o, [(h, j_logistic()) for h in hidden],
                   j_softmax(), JRng(JNB, seed=seed))
    tmpl = t_gen_net(TB, i, o, [(h, t_logistic()) for h in hidden],
                     t_softmax(), TRng(TB, 0))
    return jn, network_from_arrays(
        {f"param_{k}": np.asarray(p) for k, p in enumerate(jn.params)}, {},
        tmpl, TB)


def flagship():
    return nets(784, 10, [300, 100], 0)


def same(pair, n, batch_size, opt=False, **kw):
    """The port's plans, held to the JAX package's entry for entry."""
    jp = JPL.plan_meshes(pair[0], n, batch_size,
                         optimizer=j_adam() if opt else None, **kw)
    tp = plan_meshes(pair[1], n, batch_size,
                     optimizer=t_adam() if opt else None, **kw)
    assert tp == jp
    assert describe_plans(tp) == JPL.describe_plans(jp)
    return tp


def test_plan_enumerates_and_ranks():
    plans = same(flagship(), 8, 4096, opt=True)
    shapes = {tuple(p["mesh_shape"].values()) for p in plans}
    assert (8, 1, 1) in shapes and (4, 2, 1) in shapes
    assert (2, 2, 2) in shapes
    assert all(np.prod(list(s)) == 8 for s in shapes)
    # the flagship has 3 segments: no more stages
    assert not any(p["mesh_shape"]["stage"] > 3 for p in plans)
    costs = [p["analytic_cost"] for p in plans]
    assert costs == sorted(costs)
    dp_only = next(p for p in plans
                   if tuple(p["mesh_shape"].values()) == (8, 1, 1))
    assert dp_only["bubble_fraction"] == 0.0
    assert dp_only["stage_balance"] == 1.0
    assert plans[0]["mesh_shape"]["data"] == 8
    s = describe_plans(plans)
    assert "(8,1,1)" in s and "bubble" in s


def test_plan_flags_idle_tp_and_batch_misfit():
    # all-odd widths: no weight divides by 2 on either rule
    plans = same(nets(15, 5, [9], 1), 4, 64)
    tp2 = [p for p in plans if p["mesh_shape"]["model"] == 2]
    assert tp2 and all(not p["tp_engaged"] for p in tp2)
    assert all(any("tp_idle" in n for n in p["notes"]) for p in tp2)
    # without a stage axis param_specs' either-dim rule column-splits the
    # flagship's (10, 100) head at tp=4; every pipeline config at tp=4 is
    # idle (the row rule needs 4 | 10)
    pf = same(flagship(), 8, 4096)
    dp_tp = next(p for p in pf
                 if tuple(p["mesh_shape"].values()) == (2, 1, 4))
    assert dp_tp["tp_engaged"]
    assert not any("tp_idle" in n or "tp_partial" in n
                   for n in dp_tp["notes"])
    pp_tp = [p for p in pf if p["mesh_shape"]["stage"] > 1
             and p["mesh_shape"]["model"] == 4]
    assert pp_tp and all(not p["tp_engaged"] for p in pp_tp)
    # engaged tp divides the per-device FLOPs; idle tp does not
    pe = same(nets(16, 4, [8], 2), 4, 64)
    dp4 = next(p for p in pe if tuple(p["mesh_shape"].values()) == (4, 1, 1))
    tp2e = next(p for p in pe
                if tuple(p["mesh_shape"].values()) == (2, 1, 2))
    assert tp2e["flops_per_device"] == pytest.approx(
        dp4["flops_per_device"], rel=1e-9)
    tp2o = next(p for p in plans
                if tuple(p["mesh_shape"].values()) == (2, 1, 2))
    dp4o = next(p for p in plans
                if tuple(p["mesh_shape"].values()) == (4, 1, 1))
    assert tp2o["flops_per_device"] == pytest.approx(
        2 * dp4o["flops_per_device"], rel=1e-9)
    small = same(nets(16, 4, [8], 2), 8, 4)
    assert not any(p["mesh_shape"]["data"] == 8 for p in small)


def test_plan_memory_accounting():
    pair = flagship()
    n_param = sum(int(np.prod(p.shape)) for p in pair[1].params)
    bytes_per = pair[1].params[0].element_size()
    plans = same(pair, 8, 4096, opt=True, shard_opt_state=True)
    dp_only = next(p for p in plans
                   if tuple(p["mesh_shape"].values()) == (8, 1, 1))
    # params + grads whole, 2 moments / dp=8
    want = 2 * n_param * bytes_per + 2 * n_param * bytes_per / 8
    assert dp_only["training_state_bytes_per_device"] == int(want)
    assert any("zero1" in n for n in dp_only["notes"])
    pp2 = next(p for p in plans
               if tuple(p["mesh_shape"].values()) == (4, 2, 1))
    assert (pp2["training_state_bytes_per_device"]
            < dp_only["training_state_bytes_per_device"])
    # a bf16 net counts 2 bytes an element (its tensors' element size)
    bf = type(pair[1])(pair[1].op, tuple(p.to(torch.bfloat16)
                                         for p in pair[1].params),
                       pair[1].act_names)
    kw = dict(optimizer=t_adam(), shard_opt_state=True)
    assert plan_meshes(bf, 8, 4096, **kw) == plan_meshes(
        pair[1], 8, 4096, dtype_bytes=2, **kw)


def test_plan_zero2_memory_accounting():
    pair = flagship()
    n_param = sum(int(np.prod(p.shape)) for p in pair[1].params)
    bytes_per = pair[1].params[0].element_size()
    plans = same(pair, 8, 4096, opt=True, zero_stage=2)
    dp_only = next(p for p in plans
                   if tuple(p["mesh_shape"].values()) == (8, 1, 1))
    # params whole; grads + 2 moments / dp=8
    want = n_param * bytes_per + 3 * n_param * bytes_per / 8
    assert dp_only["training_state_bytes_per_device"] == int(want)
    assert any("zero2" in n for n in dp_only["notes"])
    p1 = same(pair, 8, 4096, opt=True, zero_stage=1)
    ps = same(pair, 8, 4096, opt=True, shard_opt_state=True)
    assert ([p["training_state_bytes_per_device"] for p in p1]
            == [p["training_state_bytes_per_device"] for p in ps])
