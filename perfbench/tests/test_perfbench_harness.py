"""The harness on the CPU: the result line, the statistics, the import
check, and files found by name."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import bench

ROOT = Path(bench.ROOT)
CELLS = ["mlp-fit", "elman-fit", "mlp-fold"]
RATE = {"mlp-fit": "train_samples_per_s", "elman-fit": "train_sequences_per_s",
        "mlp-fold": "fold_samples_per_s"}


@pytest.fixture(scope="module")
def results(spec, small):
    return {w: bench.run_cell(spec, w, 2**31 + 7, 1.5, False, "cpu",
                              sizes=small[w]) for w in CELLS}


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_keys(results, spec, workload):
    r = results[workload]
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "checks"
    assert {"metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in spec.end_to_end(workload)}
    assert set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"}
        # a CPU run holds no device memory
        assert m["value"] > 0 or name == "peak_device_mb"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["checks"]) == set(spec.limits(workload))
    json.dumps(r)


def test_check_lines_name_value_and_limit(results):
    lines = bench.check_lines(results["mlp-fit"])
    assert lines and all("limit" in ln for ln in lines)


@pytest.mark.parametrize("workload", CELLS)
def test_rate_is_all_work_over_all_time(results, spec, small, workload):
    """The rate times the window's length is the work attempted: every
    sample of every step in the window counted (the fold: a window of at
    least ``--seconds``; a fit cell: the traffic's fixed number of epochs
    a second of ``--seconds``, after the checked first epoch)."""
    r = results[workload]
    rate = r["metrics"][RATE[workload]]["value"]
    per_step = {"mlp-fit": 100,
                "elman-fit": small["elman-fit"]["traffic"]["batch_size"],
                "mlp-fold": 1}[workload]
    span = r["attempted"] * per_step / rate
    if workload == "mlp-fold":
        assert span >= 1.5
        return
    cell = spec.workload(workload)
    tr = spec.traffic(cell["traffic"])
    d = small[workload]["data"]
    rows = d.get("train_rows") or d["sequences"]
    spe = -(-rows // per_step)
    epochs = max(4 * tr["log_every_epochs"],
                 round(1.5 * tr["epochs_per_second"]))
    assert r["attempted"] == epochs * spe and span > 0


def test_ragged_epoch_rows_sum_to_the_set(spec):
    fam = spec.family("feedforward")
    assert sum(fam.rows_of_step(s, 1050, 100) for s in range(11 * 3)) == 3150


@pytest.mark.parametrize("mods,want", [
    ({"jax.numpy": 1}, ["jax"]), ({"jaxlib": 1, "flax.linen": 1},
                                  ["flax", "jaxlib"]),
    ({"tensor_ops_tpu.ops.ir": 1}, ["tensor_ops_tpu"]),
    ({"tensor_ops_tpu_torch.models": 1, "jaxtyping": 1, "numpy": 1}, [])])
def test_forbidden_modules_compare_whole_top_level_names(mods, want):
    assert bench.forbidden_modules(mods) == want


def _clean_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nfrom perfbench import bench\n"
         "print(bench.forbidden_modules())"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_a_run_loads_no_jax(spec):
    code = ("from pathlib import Path\n"
            "from perfbench import bench\n"
            "from perfbench.tests.conftest import SMALL\n"
            "for w in ('mlp-fold', 'mlp-fit'):\n"
            f"    bench.run_cell(bench.Spec(Path({str(spec.root)!r})), w, 3,"
            " 0.5, False, 'cpu', sizes=SMALL[w])")
    assert _clean_after(code) == []


def test_references_import_nothing_of_the_program():
    code = ("import sys\nfrom perfbench import bench\ns = bench.Spec()\n"
            "for c in s.data['configs']:\n    s.reference(c['name'])\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('tensor_ops_tpu_torch', 'tensor_ops_tpu', 'jax')], "
            "sorted(sys.modules)")
    assert _clean_after(code) == []


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "mlp-fit", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "mlp-fit", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_new_files_are_found_by_name(tmp_path, small):
    """A configuration, a traffic mix, limits and a per-layer metric
    dropped into a copy as new files, and named in its BENCHMARK.json,
    are found and run without an edit to any file already there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "mnist-mlp.json").read_text())
    cfg.update(name="mlp-wide", hidden=[[400, "logistic"],
                                        [100, "logistic"]])
    (pb / "configs" / "mlp-wide.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "configs" / "mnist-mlp.py", pb / "configs" / "mlp-wide.py")
    tr = json.loads((pb / "traffic" / "fold-app-chunks.json").read_text())
    tr["chunk"] = 50
    (pb / "traffic" / "fold-halves.json").write_text(json.dumps(tr))
    shutil.copy(pb / "limits" / "mlp-fold.json", pb / "limits" / "wide-fold.json")
    (pb / "metrics" / "samples_per_chunk.wide.py").write_text(
        "def read(obs, ctx):\n    return float(obs['samples_traced'])\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "mlp-wide", "source": "https://example.org",
                         "file": "perfbench/configs/mlp-wide.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "wide-fold", "config": "mlp-wide",
                           "traffic": "fold-halves", "chips": 1,
                           "why": "a test"})
    rate = next(m for m in b["end_to_end"]
                if m["name"] == "fold_samples_per_s")
    rate["workloads"].append("wide-fold")
    for name in ("samples_per_chunk.wide", "mfu.wide"):
        b["per_layer"].append({"name": name, "unit": "samples",
                               "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "fold_samples_per_s",
                               "workloads": ["wide-fold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = bench.Spec(tmp_path)
    assert spec.traffic("fold-halves")["chunk"] == 50
    assert spec.reference("mlp-wide").layers(spec.config_file("mlp-wide"))[0] \
        == (400, 784, "logistic")
    assert [m["name"] for m in spec.per_layer("wide-fold")] == [
        "samples_per_chunk.wide", "mfu.wide"]
    assert spec.reader("samples_per_chunk.wide").read(
        {"samples_traced": 50}, None) == 50.0
    # a metric without a file of its own is read by its quantity's
    assert spec.reader("mfu.wide").__doc__ == spec.reader("mfu.fold").__doc__
    r = bench.run_cell(spec, "wide-fold", 5, 0.5, False, "cpu",
                       sizes=small["mlp-fold"] | {"traffic": {}})
    assert r["correct"] is True and r["attempted"] % 50 == 0


def test_adam_traffic_is_followed(spec, small):
    """A traffic file may name adam: the first gradient is worked out from
    the program's first moment, and the reference follows with its own
    adam (an adam cell's limits would be its own, set from its readings:
    here only the loss and the first gradient, which do not depend on
    them)."""
    sizes = dict(small["mlp-fit"], traffic={"optimizer": {
        "kind": "adam", "lr": 0.001, "b1": 0.9, "b2": 0.999, "eps": 1e-8}})
    r = bench.run_cell(spec, "mlp-fit", 2**31 + 3, 1.0, False, "cpu",
                       sizes=sizes)
    assert r["checks"]["grad1_gap"]["value"] < 1e-6, r["checks"]
    assert r["checks"]["loss_gap"]["value"] < 1e-5, r["checks"]
