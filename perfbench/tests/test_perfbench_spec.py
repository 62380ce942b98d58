"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and bounds, and every name leading to its files."""

import json
import re

import pytest

from perfbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def b():
    return json.loads((bench.ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(b):
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["perfbench"]
    assert len(json.dumps(b)) < 64 * 1024


def test_a_full_check_fits(b):
    cells = 24
    total = ((2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 2 * 90
             + 1200)
    assert total <= 43200


def test_names_units_and_lines(b):
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in names
            names.add((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_and_cells(b):
    cfgs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in cfgs
        used.add(w["config"])
        assert (bench.ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (bench.ROOT / "perfbench" / "limits"
                / f"{w['name']}.json").is_file()
    assert used == set(cfgs)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
        assert (bench.ROOT / c["file"]).with_suffix(".py").is_file()


def test_metrics(b, spec):
    """Every cell reports its rate, its peak memory and its set-up, and
    per-layer metrics that move an end-to-end metric it reports, each read
    by a file of the benchmark."""
    assert {m["name"] for m in b["end_to_end"]} == {
        "train_samples_per_s", "train_sequences_per_s", "fold_samples_per_s",
        "peak_device_mb", "setup_s"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] == 0.25
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert spec.reader(m["name"]).read({}, None) is None
        for w in m["workloads"]:
            assert w in cells
            assert m["moves"] in {x["name"] for x in spec.end_to_end(w)}
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for w in cells:
        names = {x["name"] for x in spec.end_to_end(w)}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(w)
