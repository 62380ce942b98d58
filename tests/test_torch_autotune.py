"""The port's plan autotuner (``tensor_ops_tpu_torch/ops/autotune.py``),
the counterpart of ``tests/test_autotune.py``: each kernel's candidate
plans, the measured sweep (driven here by an injected timer: the CPU has no
card, and the plain version ignores a plan, so timing it would measure
nothing), on-disk persistence, the wrappers' probe of the cache, and the
refusals.  The JAX test that a tuned tile leaves the results unchanged
becomes ``chip_smoke.py``'s phase 29 on the card, where each candidate of
each sweep is held to the plain version and a tuned call to an explicit
``plan=`` call bit for bit; here the plain version's indifference to a plan
is what can be checked."""

import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from tensor_ops_tpu_torch.ops import autotune
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.ops.autotune import TileCache, make_key, sweep

CARD = "NVIDIA H100 80GB HBM3"
SMS = K.H100_SMS
CAP = 2 * SMS  # co-resident blocks of the step kernel (two a SM)
FLAG = (784, 300, 100, 10)


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """The module's cache on a fresh per-test file and the packaged table
    masked, so no outcome depends on this machine's ``~/.cache``."""
    cache = TileCache(str(tmp_path / "plans.json"))
    monkeypatch.setattr(autotune, "_CACHE", cache)
    monkeypatch.setattr(autotune, "_packaged", {})
    yield cache
    K.clear_plan_caches()


def _linear_legal(p, B, K_, O):
    """The C entry's checks of ``fused_linear`` (``csrc/fused_linear.cu``)."""
    if p.instance == "gemv":
        return (p.grid[0] * K.GEMV_WARPS >= O and p.grid[1:] == (1, 1)
                and B <= p.rows and p.rows in K.GEMV_ROWS)
    bm, bn, bk = K.LINEAR_INSTANCES[p.instance][1]
    gx, gy, gz = p.grid
    return (gx * bn >= O and gy * bm >= B and gz >= 1
            and (p.instance == "tile" or gz == 1) and gz * p.kchunk >= K_
            and (gz == 1 or ((gz - 1) * p.kchunk < K_
                             and p.kchunk % bk == 0
                             and p.scratch_floats == gz * B * O)))


def _w8_legal(p, B, K_, O, precision):
    gx, gy, gz = p.grid
    if gz * p.kchunk < K_ or (gz - 1) * p.kchunk >= K_:
        return False
    if p.instance == "gemv":
        return (gx * K.W8_GEMV_WARPS >= O and gy == 1 and B <= p.rows
                and (gz == 1 or p.kchunk % K.W8_GEMV_K == 0))
    rows, bn, bk = K.W8_INSTANCES[p.instance][1]
    return ((p.instance == "mma") == (precision == "default")
            and gx * bn >= O and gy * rows >= B
            and (gz == 1 or p.kchunk % bk == 0))


def _w8a8_legal(p, B, K_, O):
    chunks = -(-K_ // K.W8A8_CHUNK) * K.W8A8_CHUNK
    return (p.rows in K.W8A8_ROWS and p.tiles in K.W8A8_TILES
            and 1 <= p.split <= K.W8A8_MAX_SPLIT
            and (p.instance == "pdl" or (p.split == 1 and p.rows == 8))
            and p.kchunk % K.W8A8_CHUNK == 0
            and p.split * p.kchunk >= chunks
            and (p.split - 1) * p.kchunk < chunks
            and p.smem_bytes == K.w8a8_smem_bytes(p.instance, p.rows,
                                                  p.tiles, p.kchunk)
            and p.smem_bytes <= K.MAX_SMEM_BYTES)


def _mlp8_legal(p, B, N, L):
    return (1 <= p.rows <= K.MLP8_MAX_ROWS and p.groups * p.rows >= B
            and 2 <= p.depth <= K.MLP8_MAX_STAGES
            and p.grid <= N // K.MLP8_COLS and p.kc % 128 == 0
            and p.smem_bytes == K.mlp_w8a8_smem_bytes(p.rows, p.kc, p.depth,
                                                      p.tiles)
            and p.smem_bytes <= K.MAX_SMEM_BYTES)


# (kernel, candidates, rule, legality) at the main path's shapes and a few
# others
CASES = [
    ("linear", lambda B=B: K.linear_candidates(B, 784, 300, sms=SMS),
     lambda B=B: K.linear_plan(B, 784, 300, sms=SMS),
     lambda p, B=B: _linear_legal(p, B, 784, 300)) for B in (1, 8, 100, 512)
] + [
    ("linear", lambda: K.linear_candidates(100, 100, 10, sms=SMS),
     lambda: K.linear_plan(100, 100, 10, sms=SMS),
     lambda p: _linear_legal(p, 100, 100, 10)),
    ("mlp_fwd", lambda: K.mlp_forward_candidates(8, FLAG),
     lambda: K.mlp_forward_plan(8, FLAG),
     lambda p: p.rows in K.MLP_ROWS and p.smem_bytes <= K.MAX_SMEM_BYTES
     and p.tiles * p.rows >= 8),
    ("mlp_fwd", lambda: K.mlp_forward_candidates(63, (33, 20, 7)),
     lambda: K.mlp_forward_plan(63, (33, 20, 7)),
     lambda p: p.rows in K.MLP_ROWS and p.tiles * p.rows >= 63),
    ("mlp_train", lambda: K.train_grid_candidates(CAP, SMS, 100, FLAG),
     lambda: K.train_grid(CAP, SMS, 100, FLAG), lambda g: 1 <= g <= CAP),
    ("linear_w8", lambda: K.w8_candidates(8, 784, 300, "default", SMS),
     lambda: K.w8_plan(8, 784, 300, "default", SMS),
     lambda p: _w8_legal(p, 8, 784, 300, "default")),
    ("linear_w8", lambda: K.w8_candidates(64, 784, 300, "highest", SMS),
     lambda: K.w8_plan(64, 784, 300, "highest", SMS),
     lambda p: _w8_legal(p, 64, 784, 300, "highest")),
    ("linear_w8a8", lambda: K.w8a8_candidates(8, 784, 300, SMS),
     lambda: K.w8a8_plan(8, 784, 300, SMS),
     lambda p: _w8a8_legal(p, 8, 784, 300)),
    ("linear_w8a8", lambda: K.w8a8_candidates(64, 4096, 4096, SMS),
     lambda: K.w8a8_plan(64, 4096, 4096, SMS),
     lambda p: _w8a8_legal(p, 64, 4096, 4096)),
    ("mlp_w8a8", lambda: K.mlp_w8a8_candidates(16, 512, 3, SMS),
     lambda: K.mlp_w8a8_plan(16, 512, 3, SMS),
     lambda p: _mlp8_legal(p, 16, 512, 3)),
    ("mlp_w8a8", lambda: K.mlp_w8a8_candidates(100, 4096, 4, SMS),
     lambda: K.mlp_w8a8_plan(100, 4096, 4, SMS),
     lambda p: _mlp8_legal(p, 100, 4096, 4)),
    ("rnn_step", lambda: K.rnn_seq_candidates(1, 32, 512),
     lambda: K.rnn_seq_plan(1, 32, 512), lambda p: p in ("resident", "steps")),
    ("rnn_step", lambda: K.rnn_seq_candidates(1, 32, 1024),
     lambda: K.rnn_seq_plan(1, 32, 1024), lambda p: p == "steps"),
]


@pytest.mark.parametrize("kernel,cands,rule,legal", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_candidates_pass_the_plans_checks_and_contain_the_rule(
        plan_cache, kernel, cands, rule, legal):
    got = cands()
    assert rule() in got
    assert len(got) == len(set(got))
    assert all(legal(p) for p in got), [p for p in got if not legal(p)]
    # a sweep has something to choose from where the kernel has a choice
    if kernel not in ("rnn_step",):
        assert len(got) > 1


def _pick(target):
    """An injected timer: the plan ``target`` is fastest (one round a
    plan, so no spread)."""
    return lambda call: [1.0 if call() == target else 5.0]


def test_sweep_persists_and_linear_plan_takes_it(plan_cache):
    cands = K.linear_candidates(64, 784, 300, sms=SMS)
    rule = K.linear_plan(64, 784, 300, sms=SMS)
    target = next(p for p in cands if p != rule)
    report = {}
    best = sweep("linear", (64, 784, 300, torch.float32), cands, lambda p: p,
                 rule=rule, timer=_pick(target), dev=CARD, report=report)
    assert best == target
    # the winner is on disk with its provenance
    key = make_key("linear", dev=CARD, B=64, K=784, O=300, dtype="float32")
    assert key.endswith("|dev=NVIDIA_H100_80GB_HBM3") and report["key"] == key
    entry = json.load(open(plan_cache.path))[key]
    assert entry == {"plan": K._linear_free(target), "us": 1.0,
                     "candidates": len(cands), "spread_us": 0.0}
    assert report["rule_us"] == 5.0 and report["best_us"] == 1.0
    # the plan takes the entry for this shape on this card ...
    assert K.linear_plan(64, 784, 300, sms=SMS, device_name=CARD) == target
    # ... with the call's own loads (unaligned operands load scalars)
    assert not K.linear_plan(64, 784, 300, aligned=False, sms=SMS,
                             device_name=CARD).vec
    # another shape, another dtype and another card take the rule
    assert (K.linear_plan(128, 512, 512, sms=SMS, device_name=CARD)
            == K.linear_plan(128, 512, 512, sms=SMS))
    assert (K.linear_plan(64, 784, 300, torch.bfloat16, sms=SMS,
                          device_name=CARD) == rule)
    assert K.linear_plan(64, 784, 300, sms=SMS, device_name="NVIDIA A100"
                         ) == rule


def test_a_tie_within_the_spread_keeps_the_rule(plan_cache):
    """A plan replaces the rule only where it is faster by more than the
    larger spread of the two plans' timing rounds and ``TIE_SHARE`` of the
    rule's time; the entry records the winner's spread."""
    cands = K.train_grid_candidates(CAP, SMS, 100, FLAG)
    rule = K.train_grid(CAP, SMS, 100, FLAG)
    times = {g: [10.0, 10.5, 11.0] for g in cands}
    times[66] = [9.2, 9.6, 10.2]      # faster by 0.9 µs, spread 1.0
    report = {}
    best = sweep("mlp_train", (100, FLAG), cands, lambda g: g, rule=rule,
                 timer=lambda call: times[call()], dev=CARD, report=report)
    key = make_key("mlp_train", dev=CARD, B=100, dims="784x300x100x10")
    assert best == rule and report["best"] == [rule]
    assert json.load(open(plan_cache.path))[key] == {
        "plan": [rule], "us": 10.5, "candidates": len(cands),
        "spread_us": 1.0}
    times[66] = [8.0, 8.2, 8.4]       # faster by 2.3 µs, spreads 1.0, 0.4
    best = sweep("mlp_train", (100, FLAG), cands, lambda g: g, rule=rule,
                 timer=lambda call: times[call()], dev=CARD)
    assert best == 66 and K.train_grid(CAP, SMS, 100, FLAG,
                                       device_name=CARD) == 66
    # with no spread, a gain within TIE_SHARE of the rule's time is a tie
    times = {g: [10.0] for g in cands}
    times[66] = [10.0 * (1 - autotune.TIE_SHARE / 2)]
    assert sweep("mlp_train", (100, FLAG), cands, lambda g: g, rule=rule,
                 timer=lambda call: times[call()], dev=CARD) == rule
    times[66] = [10.0 * (1 - 2 * autotune.TIE_SHARE)]
    assert sweep("mlp_train", (100, FLAG), cands, lambda g: g, rule=rule,
                 timer=lambda call: times[call()], dev=CARD) == 66
    # without a rule the fastest median wins
    times[66] = [9.2, 9.6, 10.2]
    assert sweep("mlp_train", (100, FLAG), cands, lambda g: g,
                 timer=lambda call: times[call()], dev=CARD) == 66


def test_tuning_keys_are_the_plans_probes(plan_cache):
    """The sweeps and the plans' probes file an entry under one key and
    read one free-parameter list, both from ``kernels.TUNING``."""
    assert set(K.TUNING) == {"linear", "mlp_fwd", "mlp_train", "linear_w8",
                             "linear_w8a8", "mlp_w8a8", "rnn_step"}
    assert K.TUNING["linear"].key(8, 784, 300, torch.bfloat16) == dict(
        B=8, K=784, O=300, dtype="bfloat16")
    assert K.TUNING["mlp_fwd"].key(8, FLAG) == dict(B=8,
                                                    dims="784x300x100x10")
    plan = K.w8a8_plan(8, 784, 300, SMS)
    assert K.TUNING["linear_w8a8"].free(plan) == K._w8a8_free(plan)


def test_tuned_plans_do_not_change_results(plan_cache):
    """A plan is a schedule, not semantics: on the CPU the wrapper runs the
    plain version whatever plan it is given or the cache holds (on the
    card, phase 29 of ``chip_smoke.py`` holds every candidate to the plain
    version and a tuned call bit-equal to an explicit ``plan=`` call)."""
    r = np.random.default_rng(1)
    x = torch.tensor(r.normal(size=(32, 100)), dtype=torch.float32)
    w = torch.tensor(r.normal(size=(40, 100)) * 0.2, dtype=torch.float32)
    b = torch.tensor(r.normal(size=(40,)), dtype=torch.float32)
    before = K.fused_linear(x, w, b, "tanh", "highest")
    cands = K.linear_candidates(32, 100, 40, sms=SMS)
    sweep("linear", (32, 100, 40, torch.float32), cands, lambda p: p,
          timer=_pick(cands[-1]), dev=CARD)
    after = K.fused_linear(x, w, b, "tanh", "highest")
    explicit = K.fused_linear(x, w, b, "tanh", "highest", plan=cands[-1])
    assert torch.equal(before, after) and torch.equal(before, explicit)


def test_sweep_mlp_forward_flows_into_the_plan(plan_cache):
    cands = K.mlp_forward_candidates(8, FLAG)
    assert [p.rows for p in cands] == [1, 2, 4, 8]
    best = sweep("mlp_fwd", (8, FLAG), cands, lambda p: p,
                 timer=_pick(cands[1]), dev=CARD)
    assert best.rows == 2 and best.tiles == 4
    assert K.mlp_forward_plan(8, FLAG, device_name=CARD) == best
    assert K.mlp_forward_plan(9, FLAG, device_name=CARD) == \
        K.mlp_forward_plan(9, FLAG)


def test_sweep_train_grid_persists(plan_cache):
    cands = K.train_grid_candidates(CAP, SMS, 100, FLAG)
    assert cands == [33, 66, 99, 132, 264]
    best = sweep("mlp_train", (100, FLAG), cands, lambda g: g,
                 timer=_pick(66), dev=CARD)
    key = make_key("mlp_train", dev=CARD, B=100, dims="784x300x100x10")
    assert best == 66 and json.load(open(plan_cache.path))[key]["plan"] == [66]
    assert K.train_grid(CAP, SMS, 100, FLAG, device_name=CARD) == 66
    assert K.train_grid(CAP, SMS, 400, FLAG, device_name=CARD) == SMS
    # an entry the card cannot hold at once is stale
    plan_cache.put(key, {"plan": [CAP + 1], "us": 1.0, "candidates": 1})
    with pytest.raises(ValueError, match="mlp_train.*plans.json"):
        K.train_grid(CAP, SMS, 100, FLAG, device_name=CARD)


def test_cache_survives_process_boundary_simulation(plan_cache):
    """A fresh TileCache on the same path (a new process) sees the entry;
    a corrupt file reads as empty, never raises."""
    cands = K.w8_candidates(8, 784, 300, "default", SMS)
    sweep("linear_w8", (8, 784, 300, "default"), cands, lambda p: p,
          timer=_pick(cands[0]), dev=CARD)
    key = make_key("linear_w8", dev=CARD, B=8, K=784, O=300,
                   precision="default")
    assert TileCache(plan_cache.path).get(key)["plan"] == ["gemv", 1]
    with open(plan_cache.path, "w") as f:
        f.write("{corrupt")
    assert TileCache(plan_cache.path).get(key) is None


def test_packaged_table_fallback(plan_cache, monkeypatch, tmp_path):
    """A miss in the user cache falls through to the packaged
    ``ops/tuned_plans.json``; a user-cache entry for the same key wins; a
    foreign card never matches; the shipped table is empty (filling it
    would change the main path's plans)."""
    key = make_key("linear_w8a8", dev=CARD, B=8, K=784, O=300)
    pkg = tmp_path / "tuned_plans.json"
    pkg.write_text(json.dumps({key: {"plan": ["pdl", 8, 4, 2], "us": 1.0,
                                     "candidates": 2}}))
    monkeypatch.setattr(autotune, "_PACKAGED_PATH", str(pkg))
    monkeypatch.setattr(autotune, "_packaged", None)
    assert autotune.get_tuned("linear_w8a8", dev=CARD, B=8, K=784,
                              O=300) == ("pdl", 8, 4, 2)
    tuned = K.w8a8_plan(8, 784, 300, SMS, device_name=CARD)
    assert K._w8a8_free(tuned) == ["pdl", 8, 4, 2]
    plan_cache.put(key, {"plan": ["fused", 8, 1, 1], "us": 0.5,
                         "candidates": 2})
    assert autotune.get_tuned("linear_w8a8", dev=CARD, B=8, K=784,
                              O=300) == ("fused", 8, 1, 1)
    assert autotune.get_tuned("linear_w8a8", dev="NVIDIA A100", B=8, K=784,
                              O=300) is None
    # a forced instance is never replaced by a tuned entry
    assert K.w8a8_plan(8, 784, 300, SMS, "pdl", device_name=CARD) == \
        K.w8a8_plan(8, 784, 300, SMS, "pdl")
    monkeypatch.setattr(autotune, "_PACKAGED_PATH",
                        autotune.__file__.replace("autotune.py",
                                                  "tuned_plans.json"))
    monkeypatch.setattr(autotune, "_packaged", None)
    assert autotune._packaged_plans() == {}


def test_sweep_linear_w8_persists_and_plan_consumes(plan_cache):
    cands = K.w8_candidates(64, 784, 300, "highest", SMS)
    assert {p.instance for p in cands} == {"simt"}
    target = next(p for p in cands if p.split == 2)
    sweep("linear_w8", (64, 784, 300, "highest"), cands, lambda p: p,
          timer=_pick(target), dev=CARD)
    assert K.w8_plan(64, 784, 300, "highest", SMS, device_name=CARD) == target
    # the other precision is another key
    assert (K.w8_plan(64, 784, 300, "default", SMS, device_name=CARD)
            == K.w8_plan(64, 784, 300, "default", SMS))


def test_sweep_linear_w8a8_persists_and_plan_consumes(plan_cache):
    cands = K.w8a8_candidates(8, 784, 300, SMS)
    assert {p.instance for p in cands} == {"fused", "pdl"}
    target = next(p for p in cands if p.instance == "pdl" and p.split > 1)
    sweep("linear_w8a8", (8, 784, 300), cands, lambda p: p,
          timer=_pick(target), dev=CARD)
    key = make_key("linear_w8a8", dev=CARD, B=8, K=784, O=300)
    assert json.load(open(plan_cache.path))[key]["plan"] == \
        K._w8a8_free(target)
    assert K.w8a8_plan(8, 784, 300, SMS, device_name=CARD) == target
    # B > 8 has no one-launch candidate
    assert all(p.instance == "pdl"
               for p in K.w8a8_candidates(9, 784, 300, SMS))


def test_sweep_mlp_w8a8_persists_and_plan_consumes(plan_cache):
    cands = K.mlp_w8a8_candidates(16, 512, 3, SMS)
    rule = K.mlp_w8a8_plan(16, 512, 3, SMS)
    target = next(p for p in cands if p.rows == 8 and p.depth == 2)
    assert target.groups == 2 and rule.rows == 16
    sweep("mlp_w8a8", (16, 512, 3), cands, lambda p: p, timer=_pick(target),
          dev=CARD)
    assert K.mlp_w8a8_plan(16, 512, 3, SMS, device_name=CARD) == target
    assert (K.mlp_w8a8_plan(16, 512, 4, SMS, device_name=CARD)
            == K.mlp_w8a8_plan(16, 512, 4, SMS))


def test_sweep_rnn_step_persists_and_plan_consumes(plan_cache):
    assert K.rnn_seq_candidates(1, 32, 512) == ["resident", "steps"]
    sweep("rnn_step", (1, 32, 512), ["resident", "steps"], lambda p: p,
          timer=_pick("steps"), dev=CARD)
    assert K.rnn_seq_plan(1, 32, 512, device_name=CARD) == "steps"
    assert K.rnn_seq_plan(1, 32, 512) == "resident"
    # "resident" at a shape it does not fit is stale
    key = make_key("rnn_step", dev=CARD, B=8, I=32, O=512)
    plan_cache.put(key, {"plan": ["resident"], "us": 1.0, "candidates": 1})
    with pytest.raises(ValueError, match="rnn_step"):
        K.rnn_seq_plan(8, 32, 512, device_name=CARD)


def test_empty_cache_leaves_every_rule(plan_cache):
    """With no entry every plan is the fixed rule's, card name or not."""
    assert K.linear_plan(100, 784, 300, sms=SMS, device_name=CARD) == \
        K.linear_plan(100, 784, 300, sms=SMS)
    assert K.mlp_forward_plan(8, FLAG, device_name=CARD) == \
        K.mlp_forward_plan(8, FLAG)
    assert K.train_grid(CAP, SMS, 100, FLAG, device_name=CARD) == SMS
    assert K.w8_plan(8, 784, 300, device_name=CARD) == K.w8_plan(8, 784, 300)
    assert K.w8a8_plan(8, 784, 300, device_name=CARD) == \
        K.w8a8_plan(8, 784, 300)
    assert K.mlp_w8a8_plan(16, 512, 3, device_name=CARD) == \
        K.mlp_w8a8_plan(16, 512, 3)
    assert K.rnn_seq_plan(1, 32, 512, device_name=CARD) == "resident"


def test_put_clears_the_wrappers_call_caches(plan_cache):
    """A new entry reaches the next call of a shape already planned: a put
    empties the wrappers' per-shape caches (the counterpart of the JAX
    tests' ``jax.clear_caches()``)."""
    caches = (K._linear_calls, K._mlp_calls, K._train_grids, K._w8_calls,
              K._w8a8_calls, K._mlp8_calls, K._seq_routes)
    for c in caches:
        c["shape"] = "planned"
    plan_cache.put("linear|B=1|dev=X", {"plan": ["gemv", 1], "us": 1.0,
                                        "candidates": 1})
    assert all(not c for c in caches)


def test_stale_entries_raise_naming_the_key_and_file(plan_cache):
    key = make_key("linear", dev=CARD, B=100, K=784, O=300, dtype="float32")
    plan_cache.put(key, {"plan": ["gemv", 1], "us": 1.0, "candidates": 3})
    with pytest.raises(ValueError) as e:
        K.linear_plan(100, 784, 300, sms=SMS, device_name=CARD)
    assert key in str(e.value) and plan_cache.path in str(e.value)
    key = make_key("mlp_fwd", dev=CARD, B=8, dims="784x300x100x10")
    plan_cache.put(key, {"plan": [16], "us": 1.0, "candidates": 3})
    with pytest.raises(ValueError, match="mlp_fwd"):
        K.mlp_forward_plan(8, FLAG, device_name=CARD)


@pytest.mark.parametrize("name,args", [
    ("autotune_linear", (8, 784, 300)),
    ("autotune_mlp_forward", (8, FLAG, ["logistic"] * 3)),
    ("autotune_mlp_train_step", (100, FLAG, ["logistic"] * 3)),
    ("autotune_linear_w8", (8, 784, 300)),
    ("autotune_linear_w8a8", (8, 784, 300)),
    ("autotune_mlp_w8a8", (16, 512, 3)),
    ("autotune_rnn_step", (1, 32, 512)),
])
def test_autotune_on_the_cpu_names_the_card(plan_cache, name, args):
    """The sweeps time a kernel on a card; the CPU's plain version ignores
    a plan, so each entry refuses there (nothing is written)."""
    with pytest.raises(RuntimeError, match="CUDA card"):
        getattr(autotune, name)(*args, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card is visible"):
            getattr(autotune, name)(*args)
    assert not os.path.exists(plan_cache.path)
