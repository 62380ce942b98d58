"""The port's ring collectives against the JAX package's Pallas rings, run
as ``tests/test_collective_kernels.py`` runs them: in TPU interpret mode
under ``shard_map`` on the 8-device CPU mesh of ``tests/conftest.py``.

On the CPU the wrappers take their plain versions (step-by-step
simulations of the TPU schedule on the JAX chunk layout); the CUDA kernels
are held against the same plain versions on the card by ``chip_smoke.py``.
Every comparison is bit for bit, for int32 and for random-normal f32: each
element is summed in the same ring order, so no tolerance is needed.  The
global input is split over the ranks along its leading axis, as
``P("data")`` splits it, and the per-rank results are concatenated as
``out_specs=P("data")`` concatenates them.  Each JAX result is computed
once per module (interpret-mode runs take seconds each)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tensor_ops_tpu.parallel import collective_kernels as JC
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.parallel import collective_kernels as C

N_DEV = 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < N_DEV, reason="needs the 8-device CPU mesh")

# ring -> (JAX function, port wrapper, port plain version)
RINGS = {
    "one-way": (JC.ring_all_reduce, C.ring_all_reduce,
                C.ring_all_reduce_ref),
    "bidir-ar": (JC.ring_all_reduce_bidir, C.ring_all_reduce_bidir,
                 lambda xs: C.bidir_ring_ref(xs, "ar")),
    "rs": (JC.ring_reduce_scatter, C.ring_reduce_scatter,
           lambda xs: C.bidir_ring_ref(xs, "rs")),
    "ag": (JC.ring_all_gather, C.ring_all_gather,
           lambda xs: C.bidir_ring_ref(xs, "ag")),
}

# (ring, ranks, global shape, dtype, seed): the shapes of
# test_collective_kernels.py, its awkward shapes (:72-80, :125-131) shared
# between the two rings, each in one of the two dtypes, and every ring at
# n = 2 (the JAX tests' two-device case, :149-155)
CASES = [
    ("one-way", 8, (128, 128), "int32", 0),
    ("one-way", 8, (64, 128), "float32", 1),
    ("one-way", 8, (64, 3, 7), "int32", 2),
    ("one-way", 8, (64,), "int32", 2),
    ("bidir-ar", 8, (128, 128), "int32", 0),
    ("bidir-ar", 8, (64, 128), "float32", 4),
    ("bidir-ar", 8, (64, 3, 7), "float32", 5),
    ("bidir-ar", 8, (64, 50), "int32", 5),
    ("rs", 8, (128, 128), "int32", 6),
    ("rs", 8, (64, 3, 7), "float32", 6),
    ("ag", 8, (64, 128), "float32", 7),
    ("ag", 8, (16, 3, 5), "int32", 7),
    ("one-way", 2, (16, 128), "int32", 8),
    ("one-way", 2, (16, 128), "float32", 8),
    ("bidir-ar", 2, (16, 128), "int32", 0),
    ("bidir-ar", 2, (16, 3, 7), "float32", 9),
    ("rs", 2, (32, 128), "float32", 10),
    ("rs", 2, (16,), "int32", 10),
    ("ag", 2, (16, 128), "int32", 11),
    ("ag", 2, (6, 3, 5), "float32", 11),
]


def global_input(shape, dtype, seed):
    """int32 arange for the JAX tests' first case (seed 0), else int32 in
    [-100, 100) or f32 N(0, 1) from ``default_rng(seed)``."""
    if dtype == "int32" and seed == 0:
        return np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    r = np.random.default_rng(seed)
    if dtype == "int32":
        return r.integers(-100, 100, size=shape).astype(np.int32)
    return r.normal(size=shape).astype(np.float32)


def jax_ring(fn, x, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    f = jax.shard_map(lambda v: fn(v, "data"), mesh=mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def jax_results():
    """JAX ring outputs, each computed on first use and kept."""
    cache = {}

    def get(ring, n, shape, dtype, seed):
        key = (ring, n, shape, dtype, seed)
        if key not in cache:
            cache[key] = jax_ring(RINGS[ring][0],
                                  global_input(shape, dtype, seed), n)
        return cache[key]

    return get


def per_rank(x, n):
    return list(torch.tensor(x).chunk(n))


def same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and (got.view(np.int32) == want.view(np.int32)).all())


@pytest.mark.parametrize("ring,n,shape,dtype,seed", CASES,
                         ids=[f"{c[0]}-n{c[1]}-{'x'.join(map(str, c[2]))}-"
                              f"{c[3]}" for c in CASES])
def test_plain_ring_matches_jax_ring_bit_for_bit(jax_results, ring, n, shape,
                                                 dtype, seed):
    want = jax_results(ring, n, shape, dtype, seed)
    xs = per_rank(global_input(shape, dtype, seed), n)
    _, wrapper, ref = RINGS[ring]
    got = wrapper(xs)
    assert len(got) == n
    assert all(g.dtype == xs[0].dtype for g in got)
    assert same_bits(torch.cat(got).numpy(), want)
    assert same_bits(torch.cat(ref(xs)).numpy(), want)


def test_rs_then_ag_composes_to_all_reduce(jax_results):
    """reduce-scatter then all-gather == the JAX bidirectional all-reduce
    (the ZeRO-2 decomposition), bit for bit."""
    want = jax_results("bidir-ar", 8, (128, 128), "int32", 0)
    xs = per_rank(global_input((128, 128), "int32", 0), 8)
    got = C.ring_all_gather(C.ring_reduce_scatter(xs))
    assert same_bits(torch.cat(got).numpy(), want)


def test_reduce_scatter_rejects_indivisible_leading_axis():
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("data",))
    x = jnp.ones((N_DEV * 8 + 8, 4), jnp.float32)
    with pytest.raises(ValueError, match="divisible by the ring size") as j:
        jax.jit(jax.shard_map(
            lambda v: JC.ring_reduce_scatter(v, "data"), mesh=mesh,
            in_specs=P("data"), out_specs=P("data"), check_vma=False))(x)
    xs = per_rank(np.ones((N_DEV * 8 + 8, 4), np.float32), N_DEV)
    with pytest.raises(ValueError, match="divisible by the ring size") as p:
        C.ring_reduce_scatter(xs)
    assert str(p.value) == str(j.value)
    with pytest.raises(ValueError, match="divisible by the ring size"):
        C.bidir_ring_ref(xs, "rs")


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_one_rank_returns_its_input(ring):
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    for fn in RINGS[ring][1:]:
        (got,) = fn([x])
        assert got is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.float64,
                                   torch.bfloat16])
def test_dtypes_are_kept(dtype):
    xs = [torch.arange(24, dtype=torch.float32).reshape(4, 6).to(dtype) + r
          for r in range(4)]
    want = sum(x.double() for x in xs)
    for fn in (C.ring_all_reduce, C.ring_all_reduce_bidir):
        got = fn(xs)
        assert [g.dtype for g in got] == [dtype] * 4
        assert all(torch.equal(g.double(), want) for g in got)
    rs = C.ring_reduce_scatter(xs)
    assert [tuple(g.shape) for g in rs] == [(1, 6)] * 4
    assert all(g.dtype == dtype for g in rs)
    assert torch.equal(torch.cat(rs).double(), want)
    ag = C.ring_all_gather(xs)
    assert all(g.dtype == dtype and torch.equal(g, torch.cat(xs))
               for g in ag)


@pytest.mark.parametrize("size,n", [(235200, 4), (300, 4), (30000, 4),
                                    (100, 4), (1000, 4), (10, 4),
                                    (8 * 8 * 21, 8), (1, 2)])
def test_layout_is_the_jax_layout(size, n):
    """The bidirectional layout's pieces are ``_pad_to_halves``'s halves;
    the one-way chunks are ``ring_all_reduce``'s ``per_dev`` (:117-121),
    at the flagship's six parameter sizes and two small ones."""
    D, H, stride, x_len, x_size = C._layout("ar", (size,), n)
    halves = JC._pad_to_halves(jnp.zeros(size, jnp.float32), n)
    assert (D, H) == (2, halves.shape[2] * JC.LANE)
    assert (stride, x_len, x_size) == (2 * H, 2 * H, size)
    chunk = JC.LANE * JC.SUBLANE
    per_dev = ((size + n * chunk - 1) // (n * chunk)) * chunk
    assert C._layout("ar", (size,), n, one_way=True)[:2] == (1, per_dev)


def test_inputs_are_checked():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="rank 1"):
        C.ring_all_reduce([a, torch.zeros(4, 2)])
    with pytest.raises(ValueError, match="rank 1"):
        C.ring_all_reduce_bidir([a, a.double()])
    with pytest.raises(ValueError, match="one tensor per rank"):
        C.ring_all_gather([])
    with pytest.raises(ValueError, match="leading axis"):
        C.ring_all_gather([torch.tensor(1.0)] * 2)
    with pytest.raises(ValueError, match="unknown phase"):
        C.bidir_ring_ref([a, a], "psum")


def test_cpu_collectives_launch_no_kernel():
    K.reset_launch_counts()
    xs = [torch.ones(8, 2) for _ in range(4)]
    for fn in (C.ring_all_reduce, C.ring_all_reduce_bidir,
               C.ring_reduce_scatter, C.ring_all_gather):
        fn(xs)
    counts = K.launch_counts()
    assert counts["ring_all_reduce"] == counts["bidir_ring"] == 0


def test_blocks_per_rank_fills_the_card_and_refuses_what_cannot_be_resident(
        monkeypatch):
    """Each rank runs one block per 1,024 elements it sends per step (both
    directions' pieces), as many as the card holds for all its ranks at
    once; ranks that cannot each have one resident block, or more ranks of
    one card than one launch takes, raise ValueError naming R, before any
    launch (no hang)."""
    monkeypatch.setattr(C, "ring_capacity", lambda lib, device: 1056)
    # the flagship's first weight, R = 4 on one card: two pieces of 29,696
    D, H = C._layout("ar", (235200,), 4)[:2]
    assert C._blocks_per_rank("bidir_ring", {0: [0, 1, 2, 3]}, D * H) == 58
    # the 10-wide bias: two pieces of 1,024
    D, H = C._layout("ar", (10,), 4)[:2]
    assert C._blocks_per_rank("bidir_ring", {0: [0, 1, 2, 3]}, D * H) == 2
    # a piece too large for every block to be resident: capped by the card
    assert C._blocks_per_rank("bidir_ring", {0: list(range(8))},
                              1 << 30) == 1056 // 8
    ranks = list(range(C.MAX_LOCAL_RANKS + 1))
    with pytest.raises(ValueError, match=rf"R={len(ranks)} ranks on cuda:1; "
                                         rf"one launch runs at most 16"):
        C._blocks_per_rank("bidir_ring", {0: [0], 1: ranks}, 1024)
    monkeypatch.setattr(C, "ring_capacity", lambda lib, device: 8)
    with pytest.raises(ValueError, match=r"R=9 ranks on cuda:0 .* holds 8"):
        C._blocks_per_rank("ring_all_reduce", {0: list(range(9))}, 1024)


class _FakeStream:
    def __init__(self, card):
        self.card, self.waited = card, []

    def wait_event(self, event):
        self.waited.append(event.card)


class _FakeEvent:
    def record(self, stream):
        self.card = stream.card


@pytest.mark.parametrize("cards", [[0], [0, 1], [0, 1, 2, 3]])
def test_cross_card_launches_wait_for_every_cards_flag_fill(monkeypatch,
                                                            cards):
    """Each card zero-fills its flags on its own stream; before a ring's
    first launch every card's stream waits for every other card's, so that
    no late fill wipes a neighbour's release.  One card needs no wait."""
    streams = {c: _FakeStream(c) for c in cards}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda c: streams[c])
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    C._order_after_fill(cards)
    for c in cards:
        assert sorted(streams[c].waited) == [o for o in cards if o != c]


def test_a_new_scratch_is_ordered_after_its_fills(monkeypatch):
    """The ordering is asked for whenever the scratch is made (first use,
    or grown), over the cards its ranks sit on, and not on a reuse; each
    call takes the next epoch."""
    made, ordered = [], []

    class FakeScratch:
        def __init__(self, devices, slot_words, nb_cap):
            self.slot_words, self.nb_cap, self.epoch = slot_words, nb_cap, 0
            made.append((slot_words, nb_cap))

    monkeypatch.setattr(C, "_Scratch", FakeScratch)
    monkeypatch.setattr(C, "_order_after_fill", ordered.append)
    monkeypatch.setattr(C, "_scratch", {})
    devs = tuple(torch.device(f"cuda:{r % 2}") for r in range(4))
    sc, epoch = C._get_scratch("bidir_ring", devs, 4096, 2)
    assert (made, ordered, epoch) == ([(4096, 2)], [[0, 1]], 1)
    assert C._get_scratch("bidir_ring", devs, 2048, 1) == (sc, 2)
    assert len(made) == len(ordered) == 1
    sc2, epoch = C._get_scratch("bidir_ring", devs, 2048, 4)
    assert sc2 is not sc and made[-1] == (4096, 4) and epoch == 1
    assert ordered == [[0, 1], [0, 1]]
