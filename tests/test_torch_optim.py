"""The port's optimizers, clip and schedules (``models/optim.py``) against
the JAX package's, in f64: 5 steps of ``init``/``update`` from the same
parameters and gradients agree to 1e-12 on torch tensors against jax
arrays and exactly on numpy arrays, with the same state structure and
``struct_key``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu_torch.models import optim as TO
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-12
SHAPES = [(4, 3), (4,), (2, 4)]

OPTS = {
    "sgd": (TO.sgd, JO.sgd),
    "momentum": (lambda: TO.momentum(0.8), lambda: JO.momentum(0.8)),
    "nesterov": (lambda: TO.momentum(0.9, nesterov=True),
                 lambda: JO.momentum(0.9, nesterov=True)),
    "adam": (TO.adam, JO.adam),
    "adam(b1=0.5)": (lambda: TO.adam(b1=0.5, eps=1e-6),
                     lambda: JO.adam(b1=0.5, eps=1e-6)),
    "adamw": (lambda: TO.adamw(weight_decay=0.05),
              lambda: JO.adamw(weight_decay=0.05)),
}


def arrays(seed):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s) for s in SHAPES)


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in leaves(t)]
    return [tree]


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_jax(name, kind):
    t_opt, j_opt = OPTS[name][0](), OPTS[name][1]()
    assert t_opt.struct_key() == j_opt.struct_key()
    assert (t_opt.name, t_opt.hyper) == (j_opt.name, j_opt.hyper)
    p0 = arrays(0)
    if kind == "torch":
        tp, jp = tuple(map(torch.tensor, p0)), tuple(map(jnp.asarray, p0))
        atol = ATOL
    else:
        tp, jp, atol = p0, p0, 0.0
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for k in range(5):
        g = arrays(k + 1)
        tg = tuple(map(torch.tensor, g)) if kind == "torch" else g
        jg = tuple(map(jnp.asarray, g)) if kind == "torch" else g
        ts, tp = t_opt.update(ts, tp, tg, 0.05 + 0.01 * k)
        js, jp = j_opt.update(js, jp, jg, 0.05 + 0.01 * k)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(host(a), host(b), rtol=0, atol=atol)
    tl, jl = leaves(ts), leaves(js)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if isinstance(a, int):  # adam's step count stays an int
            assert a == int(b) == 5
        else:
            np.testing.assert_allclose(host(a), host(b), rtol=0, atol=atol)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = arrays(3)
    want = JO.clip_by_global_norm(tuple(map(jnp.asarray, g)), max_norm)
    got = TO.clip_by_global_norm(tuple(map(torch.tensor, g)), max_norm)
    assert all(isinstance(t, torch.Tensor) for t in got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(host(a), host(b), rtol=0, atol=ATOL)
    for a, b in zip(TO.clip_by_global_norm(g, max_norm),
                    JO.clip_by_global_norm(g, max_norm)):
        np.testing.assert_array_equal(a, b)
    norm = np.sqrt(sum((host(t) ** 2).sum() for t in got))
    assert norm <= max_norm * (1 + 1e-12)


def test_schedules_match_jax():
    for t_s, j_s in ((TO.cosine_schedule(0.1, 50, 0.1),
                      JO.cosine_schedule(0.1, 50, 0.1)),
                     (TO.cosine_schedule(0.3, 0), JO.cosine_schedule(0.3, 0)),
                     (TO.exponential_schedule(0.1, 0.9, every=7),
                      JO.exponential_schedule(0.1, 0.9, every=7))):
        assert [t_s(s) for s in range(0, 80, 3)] == \
            [j_s(s) for s in range(0, 80, 3)]


def test_moment_footprint_matches_jax():
    for t_opt, j_opt in [(TO.sgd(), JO.sgd()), (TO.momentum(), JO.momentum()),
                         (TO.adam(), JO.adam()), (TO.adamw(), JO.adamw()),
                         (None, None)]:
        for nbytes in (2, 4):
            assert TO.moment_footprint(t_opt, nbytes) == \
                JO.moment_footprint(j_opt, nbytes)


def test_custom_optimizer_keys_by_identity():
    opt = TO.Optimizer(lambda p: (), lambda s, p, g, lr: ((), p), "custom")
    assert opt.struct_key() == ("custom", "id", id(opt.update))
