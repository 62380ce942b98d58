"""Request graphs of the port's serving path, on the CPU.

On the card ``Predictor`` serves each bucket, and ``SequencePredictor``
each (bucket, length) pair, from a CUDA graph captured at warm-up, before
a reload's switch or at first use; a model on the CPU runs direct.  The
CPU cannot capture, so the ``graph_path`` fixture stands in for
``engine.capture`` as ``tests/test_torch_chain.py`` does: the stand-in warms
the forward up and returns a graph whose replay calls the captured
function, which rewrites the graph's output as a replay does.  The
serving state's bookkeeping (the graphs held by the state a reload swaps
in, their keys, the LRU beyond the buckets, the per-graph lock, the
launches a replay counts) then runs on the CPU.

The JAX package's serving soak (``tests/test_serve.py:490``) is ported
here, direct and through the graph path, held to the JAX package's
outputs for the same numpy weights (1e-5, the soak's own bound); staged-IR
``Network`` predictors are held to the JAX ``Predictor`` in float64 at
1e-9."""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu.models.recurrent as JR
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_relu as j_relu
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models.fast import FusedMLP as JFusedMLP
from tensor_ops_tpu.models.fast import QuantizedMLP as JQuantizedMLP
from tensor_ops_tpu.models.serve import Predictor as JPredictor
from tensor_ops_tpu.models.serve import SequencePredictor as JSeqPredictor
from tensor_ops_tpu.utils import checkpoint as JC
import tensor_ops_tpu_torch.models.recurrent as TR
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import (FusedMLP, Network, Predictor,
                                         QuantizedMLP, SequencePredictor)
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_relu as t_relu
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch import engine
from tensor_ops_tpu_torch.models import chain as C
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import serve as S
from tensor_ops_tpu_torch.ops import ir
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
TOL64 = 1e-9
PATHS = ["direct", "graph path"]


@pytest.fixture
def graph_path(monkeypatch):
    """Serve CPU models through the request-graph path: ``capture`` warms
    the forward up, runs the captured call once and returns a graph whose
    replay runs it again.  Returns the list of what each capture named."""
    captured = []

    def fake_capture(fn, device, what="", remedy="", streams=None,
                     pool=None):
        fn(False)
        fn(True)
        captured.append(what)
        return type("Graph", (), {"replay": staticmethod(lambda: fn(True))})

    monkeypatch.setattr(engine, "uses_graphs", lambda device: True)
    monkeypatch.setattr(engine, "capture", fake_capture)
    return captured


@pytest.fixture(autouse=True)
def zero_graph_counts():
    S.reset_graph_counts()


def use(request, path):
    if path == "graph path":
        request.getfixturevalue("graph_path")


# ---------------------------------------------------------------------------
# the JAX package's serving soak (tests/test_serve.py:490)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soak_models():
    """The soak's two serving states in both packages, and the JAX
    package's outputs for them on the soak's request."""
    jb = T.JaxBackend()
    net_a = j_gen_net(jb, 4, 3, [(8, j_logistic())], j_softmax(),
                      JRng(jb, seed=21))
    net_b = j_gen_net(jb, 4, 3, [(8, j_logistic())], j_softmax(),
                      JRng(jb, seed=22))
    ja = JFusedMLP.from_network(net_a)
    jq = JQuantizedMLP.from_fused(JFusedMLP.from_network(net_b))
    x = np.random.default_rng(4).uniform(0, 1, size=(3, 4))
    out_a = JPredictor(ja, buckets=(4,)).predict(x)
    out_q = JPredictor(jq, buckets=(4,)).predict(x)
    fa = FusedMLP.from_numpy([np.asarray(w) for w in ja.weights],
                             [np.asarray(b) for b in ja.biases], ja.acts,
                             ja.softmax_out, device="cpu")
    qb = QuantizedMLP.from_numpy(
        [np.asarray(q) for q in jq.wqs], [np.asarray(s) for s in jq.scales],
        [np.asarray(b) for b in jq.biases], jq.acts, jq.softmax_out,
        jq.mode, device="cpu")
    return fa, qb, x, np.asarray(out_a), np.asarray(out_q)


@pytest.mark.parametrize("path", PATHS)
def test_predictor_soak_under_concurrent_reloads(soak_models, path, request):
    """N predict threads race M hot swaps on one Predictor: zero
    exceptions, zero torn responses (every response is wholly the old or
    wholly the new model's, as the JAX package serves them), no request
    paid a warm-up (latency and the capture count: captures happen in
    ``warmup`` and ``reload`` only)."""
    use(request, path)
    fa, qb, x, out_a, out_q = soak_models
    np.testing.assert_allclose(Predictor(fa, buckets=(4,)).predict(x), out_a,
                               atol=ATOL)
    np.testing.assert_allclose(Predictor(qb, buckets=(4,)).predict(x), out_q,
                               atol=ATOL)
    assert not np.allclose(out_a, out_q)
    S.reset_graph_counts()

    pred = Predictor(fa, buckets=(4,))
    t0 = time.perf_counter()
    pred.warmup()
    warmup_s = time.perf_counter() - t0

    errors, torn, latencies = [], [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            t = time.perf_counter()
            try:
                out = pred.predict(x)
            except Exception as e:  # noqa: BLE001 — collected, asserted
                errors.append(repr(e))
                return
            latencies.append(time.perf_counter() - t)
            if not (np.allclose(out, out_a, atol=ATOL)
                    or np.allclose(out, out_q, atol=ATOL)):
                torn.append(np.asarray(out))
                return

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    captures = []
    try:
        for k in range(6):  # M=6 alternating hot-swaps under load
            pred.reload(qb if k % 2 == 0 else fa)
            captures.append(S.graph_counts()["captures"])
            time.sleep(0.1)  # let clients race the post-swap state too
    finally:
        stop.set()
        for t in threads:
            t.join()

    assert not errors, f"predict raised under reload: {errors[:3]}"
    assert not torn, "a request observed a torn serving state"
    assert len(latencies) > 50, "soak produced too few requests"
    lat = np.sort(latencies)
    p99 = lat[int(0.99 * (len(lat) - 1))]
    assert p99 < max(0.5 * warmup_s, 0.05), \
        f"p99 {p99:.3f}s vs warmup {warmup_s:.3f}s — a request warmed up?"
    assert pred.latency()["n"] == len(latencies)  # timer stayed coherent
    # one bucket: one capture at warmup and one before each switch, none
    # inside a request; nothing is captured on the direct path
    want = list(range(2, 8)) if path == "graph path" else [0] * 6
    assert captures == want
    assert S.graph_counts()["captures"] == want[-1]


# ---------------------------------------------------------------------------
# the graphs belong to the serving state, not to the op
# ---------------------------------------------------------------------------

def jax_net64(jb, seed):
    return j_gen_net(jb, 20, 4, [(12, j_logistic()), (7, j_relu())],
                     j_softmax(), JRng(jb, seed=seed))


@pytest.fixture(scope="module")
def two_networks(jb):
    """Two JAX f64 networks of one architecture, the JAX Predictor's
    outputs for each, and the request."""
    x = np.random.default_rng(13).uniform(0, 1, size=(6, 20))
    nets = [jax_net64(jb, s) for s in (3, 4)]
    outs = [np.asarray(JPredictor(n, jb, buckets=(4, 8)).predict(x))
            for n in nets]
    return nets, outs, x


@pytest.mark.parametrize("path", PATHS)
def test_two_networks_on_one_op_serve_apart(two_networks, path, request):
    """Two ``Network``s built on ONE op with different parameters, served
    by two Predictors: each gives its own answer, within 1e-9 of the JAX
    Predictor in f64, and they share no serving state (no graph is kept on
    the op)."""
    use(request, path)
    jnets, want, x = two_networks
    tb = TorchBackend(torch.float64, "cpu")
    tmpl = t_gen_net(tb, 20, 4, [(12, t_logistic()), (7, t_relu())],
                     t_softmax(), TRng(tb, 0))
    preds = [Predictor(Network(tmpl.op,
                               [tb.asarray(np.asarray(p)) for p in j.params],
                               tmpl.act_names), tb, buckets=(4, 8))
             for j in jnets]
    for p in preds:
        p.warmup()
    for _ in range(2):  # the second pass replays
        for p, w in zip(preds, want):
            got = p.predict(x)
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, w, rtol=0, atol=TOL64)
    a, b = (p._serving for p in preds)
    assert a[0].op is b[0].op and a is not b
    if path == "graph path":
        assert a[4] is not b[4] and a[4].keys() == b[4].keys() == (4, 8)
        assert S.graph_counts()["captures"] == 4
    else:
        assert a[4] is None and b[4] is None
    assert not any(isinstance(v, (S._Graphs, S.RequestGraph))
                   for v in tmpl.op._compiled.values())


def jax_rnet(jb, seed):
    lg = j_logistic
    return JR.gen_net(jb, 2, 1, [(5, lg(), lg())], lg(), None,
                      JRng(jb, seed=seed))


def port_rnet(jnet, tb):
    arch = jnet.arch
    lg = t_logistic
    template = TR.gen_net(tb, arch["in"], arch["out"],
                          [(h, lg(), lg()) for h in arch["sizes"]], lg(),
                          None, TRng(tb, seed=0))
    arrays, meta = JC._recurrent_payload(jnet, None)
    return TC.recurrent_from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, template, tb)


@pytest.mark.parametrize("path", PATHS)
def test_sequence_reload_keeps_the_staging_state(jb, path, request,
                                                 monkeypatch):
    """``SequencePredictor.reload`` warms a staging predictor and swaps in
    ITS serving state (network, backend and graphs) with its warmed
    lengths: the union of the old ones and ``warm_lengths``, each captured
    for every bucket before the switch; requests then equal the JAX
    SequencePredictor of the new network in f64."""
    use(request, path)
    tb = TorchBackend(torch.float64, "cpu")
    staged = []
    warmup = SequencePredictor.warmup

    def recording(self, lengths):
        staged.append(self)
        return warmup(self, lengths)

    monkeypatch.setattr(SequencePredictor, "warmup", recording)
    old, new = jax_rnet(jb, 0), jax_rnet(jb, 1)
    pred = SequencePredictor(port_rnet(old, tb), tb, buckets=(2, 4))
    pred.warmup([3, 5])
    before = S.graph_counts()["captures"]
    pred.reload(port_rnet(new, tb), warm_lengths=[7])
    staging = staged[-1]
    assert staging is not pred and pred._serving is staging._serving
    assert pred._warmed == staging._warmed == {3, 5, 7}
    graphs = pred._serving[2]
    if path == "graph path":
        assert set(graphs.keys()) == {(b, n) for b in (2, 4)
                                      for n in (3, 5, 7)}
        assert S.graph_counts()["captures"] - before == 6
    else:
        assert graphs is None and S.graph_counts()["captures"] == 0
    xs = np.random.default_rng(5).uniform(0, 1, size=(3, 5, 2)) \
        .astype(np.float32)
    want = JSeqPredictor(new, jb, buckets=(2, 4)).predict(xs)
    np.testing.assert_allclose(pred.predict(xs), np.asarray(want), rtol=0,
                               atol=TOL64)
    assert S.graph_counts()["captures"] - before == (
        6 if path == "graph path" else 0)  # (4, 5) was warm


# ---------------------------------------------------------------------------
# the CPU runs direct; the graph path's routes and bookkeeping
# ---------------------------------------------------------------------------

def small_fused(device="cpu", dims=(12, 9, 4), seed=0):
    r = np.random.default_rng(seed)
    ws = [r.normal(0, 0.5, size=(o, i)).astype(np.float32)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [r.normal(0, 0.1, size=o).astype(np.float32) for o in dims[1:]]
    return FusedMLP.from_numpy(ws, bs, ["logistic"] * (len(dims) - 2)
                               + ["identity"], True, device=device)


def stack_model():
    fm = FusedMLP.from_numpy(
        [np.random.default_rng(s).normal(0, 0.1, size=(128, 128))
         .astype(np.float32) for s in (1, 2)], [np.zeros(128, np.float32)] * 2,
        ["relu", "identity"], False, device="cpu")
    return QuantizedMLP.from_fused(fm)


def route(name):
    """(predictor, width) of one serving route, on the CPU."""
    if name == "Network":
        tb = TorchBackend(torch.float64, "cpu")
        net = t_gen_net(tb, 12, 4, [(9, t_logistic())], t_softmax(),
                        TRng(tb, 1))
        return Predictor(net, tb, buckets=(4, 8)), 12
    if name == "stack":
        return Predictor(stack_model(), buckets=(4, 8)), 128
    fm = small_fused()
    kw = {"f32 fused": {}, "per-layer": dict(use_fused_kernel=False),
          "xla": dict(xla_threshold=1), "bf16": dict(dtype="bf16")}
    if name in kw:
        return Predictor(fm, buckets=(4, 8), **kw[name]), 12
    mode = {"w8": "w8", "w8a8": "w8a8"}[name]
    return Predictor(QuantizedMLP.from_fused(fm, mode=mode),
                     buckets=(4, 8)), 12


ROUTES = ["f32 fused", "per-layer", "xla", "bf16", "w8", "w8a8", "stack",
          "Network"]


@pytest.mark.parametrize("name", ROUTES)
def test_cpu_models_capture_nothing(name):
    """An explicit CPU model runs direct: no graphs in its serving state,
    nothing captured by warmup, requests or a reload."""
    pred, width = route(name)
    pred.warmup()
    pred.predict(np.zeros((3, width), np.float32))
    pred.predict(np.zeros((11, width), np.float32))  # beyond the buckets
    pred.reload(pred.model)
    assert pred._serving[4] is None
    assert S.graph_counts() == {"captures": 0, "replays": 0}


def test_cpu_sequence_predictor_captures_nothing(jb):
    tb = TorchBackend(torch.float64, "cpu")
    pred = SequencePredictor(port_rnet(jax_rnet(jb, 2), tb), tb,
                             buckets=(2,))
    pred.warmup([4])
    pred.predict(np.zeros((3, 6, 2), np.float32))
    assert pred._serving[2] is None
    assert S.graph_counts() == {"captures": 0, "replays": 0}


@pytest.mark.parametrize("name", ROUTES)
def test_graph_path_serves_every_route_like_direct(name, graph_path):
    """Through the graph path every route's request equals its direct
    forward bit for bit, at each bucket (captured by warmup, replayed by
    requests) and beyond the buckets (captured at first use, in the LRU);
    a capture names its route and shape."""
    pred, width = route(name)
    pred.warmup()
    assert len(graph_path) == 2 and "batch 8" in graph_path[1]
    r = np.random.default_rng(8)
    for n in (3, 4, 8, 11, 3):
        x = r.uniform(0, 1, size=(n, width)).astype(np.float32)
        b = S._bucket_of(pred.buckets, n)
        xb = np.pad(x, ((0, b - n), (0, 0)))
        st = pred._serving
        want = pred._forward(st, pred._as(st, xb)).cpu().numpy()[:n]
        np.testing.assert_array_equal(pred.predict(x), want)
    assert pred._serving[4].keys() == (4, 8, 16)
    assert S.graph_counts() == {"captures": 3, "replays": 5}


def test_graph_path_keeps_beyond_bucket_graphs_in_a_bounded_lru(
        graph_path, monkeypatch):
    monkeypatch.setattr(S._Graphs, "maxsize", 3)
    pred = Predictor(small_fused(), buckets=(4,))
    pred.warmup()
    for n in (5, 9, 13, 5, 17, 21):  # buckets 8, 12, 16, 8, 20, 24
        pred.predict(np.ones((n, 12), np.float32))
    # the bucket stays; of the others the 3 most recent, 8 refreshed
    assert pred._serving[4].keys() == (4, 8, 20, 24)
    assert S.graph_counts()["captures"] == 6  # 4, then 8, 12, 16, 20, 24


def test_graph_lru_is_bounded_as_the_op_cache():
    """The graphs beyond the buckets are bounded as the JAX package bounds
    its compiled forwards (``CompiledCache``: 128 sequence lengths)."""
    assert S._Graphs.maxsize == ir.CompiledCache.DEFAULT_MAXSIZE == 128


def test_sequence_graphs_are_kept_by_length_in_a_bounded_lru(
        jb, graph_path, monkeypatch):
    """A ``SequencePredictor``'s graphs of the lengths ``warmup`` did not
    name are kept by length: a length's graphs at every batch it served
    (bucket sizes included) stay together and leave together, the least
    recently used length first; the warmed lengths stay."""
    monkeypatch.setattr(S._Graphs, "maxsize", 2)
    tb = TorchBackend(torch.float64, "cpu")
    pred = SequencePredictor(port_rnet(jax_rnet(jb, 3), tb), tb,
                             buckets=(2, 4))
    pred.warmup([3])
    r = np.random.default_rng(6)
    for b, n in ((2, 5), (4, 5), (2, 6), (1, 5), (2, 7), (3, 3)):
        xs = r.uniform(0, 1, size=(b, n, 2)).astype(np.float32)
        got = pred.predict(xs)
        rnet, be, _ = pred._serving
        bb = S._bucket_of(pred.buckets, b)
        want = S._seq_run(rnet, be, be.asarray(
            np.pad(xs, ((0, bb - b), (0, 0), (0, 0))))).numpy()[:b]
        np.testing.assert_array_equal(got, want)
    # length 5 was used again after 6, so 6 went when 7 came
    assert pred._serving[2].keys() == ((2, 3), (4, 3), (2, 5), (4, 5),
                                       (2, 7))
    assert S.graph_counts()["captures"] == 2 + 4


@pytest.mark.parametrize("kind", ["Predictor", "SequencePredictor"])
def test_reload_recaptures_the_shapes_beyond_the_buckets(jb, graph_path,
                                                         kind):
    """A reload captures, before its switch, the graphs of the shapes the
    current state served beyond its buckets (the lengths ``warmup`` did
    not name), in their LRU order: no request after the swap waits on a
    capture for a shape served before it."""
    if kind == "Predictor":
        pred = Predictor(small_fused(seed=0), buckets=(4,))
        pred.warmup()
        reqs = [np.ones((n, 12), np.float32) for n in (9, 5)]
        for x in reqs:
            pred.predict(x)
        new = small_fused(seed=1)
        fixed, extra = (4,), (12, 8)
    else:
        tb = TorchBackend(torch.float64, "cpu")
        pred = SequencePredictor(port_rnet(jax_rnet(jb, 0), tb), tb,
                                 buckets=(2,))
        pred.warmup([3])
        reqs = [np.ones((b, n, 2), np.float32)
                for b, n in ((2, 6), (1, 5), (3, 6))]
        for x in reqs:
            pred.predict(x)
        new = port_rnet(jax_rnet(jb, 1), tb)
        fixed, extra = ((2, 3),), ((2, 5), (2, 6), (4, 6))
    before = S.graph_counts()["captures"]
    assert pred._serving[-1].keys() == fixed + extra
    pred.reload(new)
    assert pred._serving[-1].keys() == fixed + extra
    assert S.graph_counts()["captures"] - before == len(fixed + extra)
    for x in reqs:
        pred.predict(x)
    assert S.graph_counts()["captures"] - before == len(fixed + extra)


def test_capture_keeps_cublas_workspaces_and_warms_up_off_the_capture_stream(
        monkeypatch):
    """``engine.capture`` leaves torch's per-(handle, stream) cuBLAS
    workspaces in place (dropping them around a capture freed memory that
    later graphs read, an illegal address on the card).  Given streams, the
    warm-up runs on the first and the capture on the second, with no
    collection; without them a collection, a new side stream for the
    warm-up and torch's own capture stream."""
    events = []

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def on(stream):
        events.append(("warm-up on", stream))
        yield

    @contextlib.contextmanager
    def graph(g, capture_error_mode, stream=None):
        events.append(("capture on", stream))
        yield

    mine = Stream()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: mine)
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: events.append("clear"), raising=False)
    monkeypatch.setattr(engine.gc, "collect",
                        lambda: events.append("collect"))
    warm, cap = Stream(), Stream()
    for streams in (None, (warm, cap)):
        events.clear()
        engine.capture(lambda commit: events.append(("fn", commit)), "cuda",
                       streams=streams)
        assert events == (["collect"] * (streams is None) + [
            ("warm-up on", warm if streams else mine), ("fn", False),
            ("capture on", cap if streams else None), ("fn", True)])


def test_concurrent_requests_on_one_graph_take_turns(graph_path):
    """Threads that send different rows to one bucket, unwarmed, under a
    short switch interval: the bucket is captured once, and every response
    is its own request's (a request that wrote the graph's input while
    another replayed would answer with the other's rows)."""
    pred = Predictor(small_fused(), buckets=(4,))
    r = np.random.default_rng(9)
    xs = [r.uniform(0, 1, size=(3, 12)).astype(np.float32) for _ in range(8)]
    st = pred._serving
    want = [pred._forward(st, pred._as(st, np.pad(x, ((0, 1), (0, 0)))))
            .numpy()[:3] for x in xs]
    bad = []

    def client(i):
        for _ in range(30):
            if not np.array_equal(pred.predict(xs[i]), want[i]):
                bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert S.graph_counts() == {"captures": 1, "replays": 240}


def test_held_launches_are_counted_by_replays():
    """A capture's wrapper calls are held, not counted (on the capturing
    thread only); a replay counts what its graph holds."""
    K.reset_launch_counts()
    seen = {}

    def other_thread():
        K._count("fused_linear")
        seen.update(K.launch_counts())

    with K.held_launches() as held:
        K._count("fused_mlp_forward")
        K._count("fused_linear_w8a8")
        K._count("fused_linear_w8a8")
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    assert held == {"fused_mlp_forward": 1, "fused_linear_w8a8": 2}
    assert seen["fused_linear"] == 1 and seen["fused_mlp_forward"] == 0
    K.count_launches(held)
    K.count_launches(held)
    counts = K.launch_counts()
    assert (counts["fused_mlp_forward"], counts["fused_linear_w8a8"],
            counts["fused_linear"]) == (2, 4, 1)
    K.reset_launch_counts()


def test_capture_error_names_what_and_remedy(monkeypatch):
    """``engine.capture`` reports what the caller was capturing and its
    remedy; the training chain keeps its own words."""
    def refuse(device=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    with pytest.raises(C.CaptureError) as info:
        engine.capture(lambda commit: None, "cuda",
                  what="the FusedMLP request forward at batch 8",
                  remedy=S._REMEDY)
    msg = str(info.value)
    assert msg.startswith("capturing the FusedMLP request forward at batch "
                          "8 in a CUDA graph failed at")
    assert S._REMEDY in msg and "chain_steps" not in msg
    with pytest.raises(C.CaptureError, match="training step.*chain_steps=1"):
        engine.capture(lambda commit: None, "cuda")


def test_a_failed_capture_raises_and_never_serves_direct(graph_path,
                                                         monkeypatch):
    """A capture that fails raises ``CaptureError`` at warmup, at a first
    use (no direct fallback) and at a reload, before its switch: the
    current model goes on serving."""
    a, b = small_fused(seed=0), small_fused(seed=1)
    x = np.random.default_rng(2).uniform(0, 1, size=(3, 12)) \
        .astype(np.float32)
    pred = Predictor(a, buckets=(4,))
    pred.warmup()
    before = pred.predict(x)
    capture = engine.capture

    def refuse(fn, device, what="", remedy="", streams=None, pool=None):
        raise C.CaptureError(f"capturing {what} failed — {remedy}")

    monkeypatch.setattr(engine, "capture", refuse)
    with pytest.raises(C.CaptureError, match="batch 4"):
        Predictor(b, buckets=(4,)).warmup()
    with pytest.raises(C.CaptureError, match="batch 8"):
        pred.predict(np.ones((7, 12), np.float32))
    with pytest.raises(C.CaptureError):
        pred.reload(b)
    assert pred.model is a
    np.testing.assert_array_equal(pred.predict(x), before)
    monkeypatch.setattr(engine, "capture", capture)
    pred.reload(b)
    assert pred.model is b and not np.array_equal(pred.predict(x), before)
