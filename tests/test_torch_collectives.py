"""The port's ring collectives against the JAX package's Pallas rings, run
as ``tests/test_collective_kernels.py`` runs them: in TPU interpret mode
under ``shard_map`` on the 8-device CPU mesh of ``tests/conftest.py``.

On the CPU the wrappers take the one-shot's plain version
(``oneshot_ref``: each element folded over the ranks in the ring's order,
in closed form); the ring protocol's plain versions simulate the TPU
schedule step by step on the JAX chunk layout.  Both are held against the
JAX rings, and against each other at ragged sizes; the CUDA kernels are held
against the same plain versions on the card by ``chip_smoke.py``.
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
from torch_threads import one_torch_thread  # noqa: F401

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
# ring -> oneshot_ref's (phase, one_way)
ONESHOT = {"one-way": ("ar", True), "bidir-ar": ("ar", False),
           "rs": ("rs", False), "ag": ("ag", False)}

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
    oneshot = C.oneshot_ref(xs, *ONESHOT[ring])
    assert same_bits(torch.cat(oneshot).numpy(), want)


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
    assert counts["ring_all_reduce.ring"] == counts["bidir_ring.ring"] == 0


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


# -- the one-shot route ---------------------------------------------------------


def ring_input(shape, n, dtype, seed):
    """One tensor per rank: f32 N(0, 1), or int32 of magnitude within 1,000
    of the int32 limit and random sign, so that the sums wrap."""
    r = np.random.default_rng(seed)
    if dtype == "int32":
        mag = r.integers(2 ** 31 - 1000, 2 ** 31, size=(n,) + shape)
        a = (mag * r.choice([-1, 1], size=mag.shape)).astype(np.int32)
    else:
        a = r.normal(size=(n,) + shape).astype(np.float32)
    return [torch.as_tensor(a[i]) for i in range(n)]


def oneshot_shapes(ring, n):
    """The layouts' edge cases: 0-d, one element, ragged tails either side
    of a 1,024-element piece, the flagship's 300x784 weight, and sizes
    below one piece per rank (n * 1024); rs blocks (the leading axis split
    n ways) whose length is or is not a multiple of 4."""
    if ring in ("one-way", "bidir-ar"):
        return [(), (1,), (3,), (1023,), (1025,), (300, 784),
                (n * 1024 - 3,), (n, 7, 11)]
    if ring == "rs":
        return [(n,), (3 * n,), (n, 1023), (n, 1025), (75 * n, 784),
                (2 * n, 513), (n, 7, 11)]
    return [(1,), (3,), (1023,), (1025,), (300, 784), (2, 5, 3)]


def same_tensors(got, want):
    return len(got) == len(want) and all(
        g.shape == w.shape and same_bits(g.numpy(), w.numpy())
        for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_oneshot_ref_equals_the_ring_protocol_bit_for_bit(n, ring, dtype):
    """The closed-form fold (each element's start rank and direction) gives
    the step-by-step ring simulation's bits, each rank's result in memory
    of its own."""
    ref = RINGS[ring][2]
    for k, shape in enumerate(oneshot_shapes(ring, n)):
        xs = ring_input(shape, n, dtype, 100 * n + k)
        got = C.oneshot_ref(xs, *ONESHOT[ring])
        assert same_tensors(got, ref(xs)), shape
        assert len({g.data_ptr() for g in got}) == n


@pytest.mark.parametrize("ring", ["one-way", "bidir-ar", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_scale_is_the_separate_multiply_bit_for_bit(ring, n):
    """``scale`` multiplies each finished f32 sum: the bits of the dp step's
    former ``sum * (1 / n)`` after the collective."""
    inv = 1.0 / n
    shapes = [(75 * n, 784), (n * 5, 7), (n,)]
    for k, shape in enumerate(shapes):
        xs = ring_input(shape, n, "float32", 31 * n + k)
        want = [t * inv for t in RINGS[ring][2](xs)]
        assert same_tensors(C.oneshot_ref(xs, *ONESHOT[ring], scale=inv),
                            want)
        if ring != "rs":
            assert same_tensors(RINGS[ring][1](xs, scale=inv), want)


class _Routes:
    """Fake launch functions: record each route's (phase, one_way, scale)."""

    def __init__(self):
        self.calls = []

    def fake(self, route):
        def launch(xs, phase, one_way, scale=None):
            self.calls.append((route, phase, one_way, scale))
            return list(xs)
        return launch


@pytest.mark.parametrize("cards,route", [
    ([0, 0, 0, 0], "oneshot"), ([1, 1], "oneshot"),
    ([0, 1, 0, 1], "ring"), ([0, 1, 2, 3], "ring")])
def test_ranks_on_one_card_take_the_oneshot_and_on_several_the_ring(
        monkeypatch, cards, route):
    routes = _Routes()
    monkeypatch.setattr(C, "_cards", lambda xs: set(cards))
    monkeypatch.setattr(C, "_oneshot", routes.fake("oneshot"))
    monkeypatch.setattr(C, "_ring_cuda", routes.fake("ring"))
    xs = [torch.ones(2 * len(cards), 3) for _ in cards]
    C.ring_all_reduce(xs)
    C.ring_all_reduce(xs, scale=0.25)
    C.ring_all_reduce_bidir(xs, scale=0.5)
    C.ring_reduce_scatter(xs)
    C.ring_all_gather(xs)
    assert routes.calls == [(route, "ar", True, None),
                            (route, "ar", True, 0.25),
                            (route, "ar", False, 0.5),
                            (route, "rs", False, None),
                            (route, "ag", False, None)]


@pytest.mark.parametrize("phase,shape,one_way,buf,vec", [
    ("ar", (300, 784), False, (4, 300, 784), True),
    ("ar", (300, 784), True, (4, 300, 784), True),
    ("ar", (10,), False, (4, 10), False),
    ("rs", (12, 3), False, (4, 3, 3), False),
    ("rs", (8, 4), False, (4, 2, 4), True),
    ("ag", (5, 3), False, (4, 20, 3), False),
    ("ag", (5, 4), False, (4, 20, 4), True),
])
def test_oneshot_call_writes_the_callers_result_shape(phase, shape, one_way,
                                                      buf, vec):
    """The results go straight into one (R, *result) buffer: the input's
    shape for ar, the leading axis / R for rs, x R for ag; 16-byte
    positions where the size (and each rs block) is a multiple of 4."""
    call = C._OneShotCall(phase, shape, 4, one_way, torch.float32, None, -1)
    d = call.desc
    assert (call.buf_shape, bool(d.vec)) == (buf, vec)
    D, H = C._layout(phase, shape, 4, one_way)[:2]
    size = int(np.prod(shape))
    part = size // 4 if phase == "rs" else size
    assert (d.size, d.H, d.D, d.part, d.n) == (size, H, D, part, 4)
    assert (d.phase, d.dtype, d.has_scale) == (C.PHASES[phase], 0, 0)
    assert torch.empty_like(call.like).shape == buf
    assert torch.empty_like(call.like).is_contiguous()
    scaled = C._OneShotCall(phase, shape, 4, one_way, torch.float32, 0.25,
                            -1)
    assert (scaled.desc.has_scale, scaled.desc.scale) == (1, 0.25)


def test_oneshot_refuses_what_its_kernel_does_not_take():
    """Checked before any launch: more ranks than one launch takes, a dtype
    the kernel has no instance for, a scale on integer sums."""
    with pytest.raises(ValueError, match="R=17 ranks .* at most 16"):
        C._oneshot([torch.zeros(4)] * 17, "ar", False)
    with pytest.raises(ValueError, match="float32 or int32"):
        C._oneshot([torch.zeros(4, dtype=torch.float64)] * 2, "ar", True)
    with pytest.raises(ValueError, match="scale applies to float32"):
        C._oneshot([torch.zeros(4, dtype=torch.int32)] * 2, "ar", True,
                   scale=0.5)
    with pytest.raises(ValueError, match="one-way ring has no phase 'rs'"):
        C.oneshot_ref([torch.zeros(4)] * 2, "rs", one_way=True)


def test_oneshot_fast_path_takes_only_its_own_call_shape(monkeypatch):
    """A cached call launches only for R contiguous tensors of its shape,
    dtype and card, read in one pass; anything else goes back to the
    checks and the routing (None)."""
    call = C._OneShotCall("ar", (3, 4), 2, False, torch.float32, None, -1)
    launched = []
    monkeypatch.setattr(call, "launch", lambda ptrs: launched.append(ptrs)
                        or "launched")
    xs = [torch.zeros(3, 4), torch.ones(3, 4)]
    assert call.fast(xs) == "launched"
    assert launched == [[x.data_ptr() for x in xs]]
    for other in (torch.zeros(4, 3), torch.zeros(3, 4, dtype=torch.int32),
                  torch.zeros(4, 3).T):
        assert call.fast([xs[0], other]) is None
    assert len(launched) == 1
