"""The traced run's parts on the CPU, with the profiler replaced by a
stand-in: a training cell traces the device alone and then the host's
launches, over whole log intervals (or chunks) of its window; the
per-layer readers find what they read."""

import pytest

from perfbench import bench, trace


class FakeTracer:
    """``trace.Tracer``'s interface; each part reads fixed numbers."""

    parts = []

    def __init__(self, spans):
        self.spans, self.data, self._on = spans, None, None

    def warm(self):
        pass

    @property
    def running(self):
        return self._on is not None

    @property
    def done(self):
        return self.data is not None and self.data.host_launches is not None

    def start(self, host_events=None):
        assert self._on is None
        if host_events is None:
            host_events = self.data is not None
        self._on = host_events
        FakeTracer.parts.append(host_events)

    def stop(self):
        host, self._on = self._on, None
        d = trace.TraceData(window_s=0.5, busy_s=0.4, device_ops=1000,
                            host_launches=300 if host else None,
                            top_ops=[["gemm", 0.3]], idle_gaps=[["x", 0.1]])
        if host and self.data is not None:
            self.data.host_launches = d.host_launches
        else:
            self.data = d
        return d


@pytest.mark.parametrize("workload,parts", [
    ("mlp-fit", [False, True]), ("elman-fit", [False, True]),
    ("mlp-fold", [False, True])])
def test_traced_parts_and_readers(spec, small, monkeypatch, workload, parts):
    FakeTracer.parts = []
    monkeypatch.setattr(trace, "Tracer", FakeTracer)
    seconds = 3.0 if workload.endswith("fit") else 1.5
    r = bench.run_cell(spec, workload, 2**31 + 21, seconds, True, "cpu",
                       sizes=small[workload])
    assert FakeTracer.parts == parts
    assert r["correct"] is True
    want = {m["name"] for m in spec.per_layer(workload)}
    assert set(r["metrics"]) == want
    assert r["breakdown"] == {"device_ops": [["gemm", 0.3]],
                              "idle_gaps": [["x", 0.1]]}
    idle = [v["value"] for k, v in r["metrics"].items()
            if k.startswith("idle_share")]
    assert idle == [pytest.approx(20.0)] * any(
        n.startswith("idle_share") for n in want)
