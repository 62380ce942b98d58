"""The harness: everything of one run that no configuration, traffic mix or
per-layer metric owns.

``BENCHMARK.json`` names the cells; each name leads to files of its own:

* a configuration's ``file`` (``perfbench/configs/<config>.json``) and its
  plain reference beside it (``<config>.py``), whose ``family`` names the
  program side in ``perfbench/families/<family>.py``;
* a cell's traffic ``perfbench/traffic/<traffic>.json``, whose ``driver``
  names the general driver of its entry, ``perfbench/drivers/<driver>.py``;
* a cell's limits ``perfbench/limits/<workload>.json``;
* a per-layer metric's reader ``perfbench/metrics/<metric>.py``, or, for
  a metric named ``<quantity>.<cells>`` without a file of its own, the
  quantity's ``perfbench/metrics/<quantity>.py`` (one quantity split by the
  end-to-end metric it moves: ``idle_share.fit``, ``idle_share.seq``).

A run sets up, measures for ``--seconds``, reads the peak memory, frees
the program's state, runs the reference comparison, checks that no JAX
module was loaded, and prints the result line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run, compared whole:
# the JAX package is ``tensor_ops_tpu``; its port ``tensor_ops_tpu_torch``
# is another name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tensor_ops_tpu")


class RunError(Exception):
    """A run that cannot produce a result (exit code ``code``)."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (its name may hold dots and
    dashes, as the benchmark's names do)."""
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


class Spec:
    """``BENCHMARK.json`` and the files its names lead to, under ``root``
    (the checkout; the benchmark's files under ``root/perfbench``)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.data = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise RunError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise RunError(f"no config {name!r} in BENCHMARK.json")

    def config_file(self, name: str) -> dict:
        return load_json(self.root / self.config(name)["file"])

    def reference(self, name: str) -> ModuleType:
        path = (self.root / self.config(name)["file"]).with_suffix(".py")
        return load_module(path, f"perfbench_ref_{name}")

    def family(self, family: str) -> ModuleType:
        return load_module(self.dir / "families" / f"{family}.py",
                           f"perfbench_family_{family}")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def driver(self, name: str) -> ModuleType:
        return load_module(self.dir / "drivers" / f"{name}.py",
                           f"perfbench_driver_{name}")

    def limits(self, workload: str) -> Dict[str, float]:
        return load_json(self.dir / "limits" / f"{workload}.json")["limits"]

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> ModuleType:
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.dir / "metrics" / f"{metric.split('.', 1)[0]}.py"
        return load_module(path, f"perfbench_metric_{metric}")


class Context:
    """What a driver gets: the cell, its configuration and reference, its
    traffic, the program side, the seed and window, the spans and, in a
    traced run, the tracer.  ``sizes`` overrides sizes of the data and
    traffic (the tests' small runs; never in a benchmark run)."""

    def __init__(self, spec: Spec, workload: str, seed: int, seconds: float,
                 trace: bool, device: str, sizes: Optional[dict] = None,
                 tmp: Optional[str] = None):
        from perfbench.trace import Spans, Tracer

        self.spec = spec
        self.cell = spec.workload(workload)
        self.name = workload
        self.cfg = spec.config_file(self.cell["config"])
        self.ref = spec.reference(self.cell["config"])
        self.family = spec.family(self.cfg["family"])
        self.traffic = dict(spec.traffic(self.cell["traffic"]))
        self.traffic.update((sizes or {}).get("traffic", {}))
        self.data_sizes = (sizes or {}).get("data", {})
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.tmp = tmp
        self.spans = Spans()
        self.tracer = Tracer(self.spans) if trace else None

    def generator(self, salt: int = 0):
        """A ``torch.Generator`` on the device seeded from the run's seed
        (any whole number; folded into 63 bits) and ``salt``."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + salt) % (1 << 63))
        return g

    def program_begins(self) -> None:
        """The benchmark has made its inputs and freed what it made them
        with: the peak memory counts from here (the program's share)."""
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def host_rng(self, salt: int = 0):
        import numpy as np

        return np.random.default_rng([self.seed % (1 << 64), salt])


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc and g++ builds are under ``build/`` already)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # a library the program uses must not load JAX behind its back
    os.environ["USE_FLAX"] = "0"


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             sizes: Optional[dict] = None) -> dict:
    """One run of ``workload``: the result line as a dict, with the numbers
    compared under ``checks`` (last).  ``device="cpu"`` runs the same path
    on the CPU at ``sizes`` (the tests), without device metrics."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device != "cpu"
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        ctx = Context(spec, workload, seed, seconds, trace, device, sizes,
                      tmp)
        limits = spec.limits(workload)
        driver = spec.driver(ctx.traffic["driver"]).Driver(ctx)
        driver.setup()
        if ctx.tracer is not None and on_card:
            ctx.tracer.warm()
        setup_s = time.perf_counter() - t_start
        obs = driver.window()
        if on_card:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
        driver.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        from perfbench.precision import full_float32

        full_float32()
        numbers = driver.check()
    from perfbench.checks import held

    numbers = dict(numbers)
    rows, ok = held(numbers, limits)
    failed = obs["failed"]
    e2e = {}
    for m in spec.end_to_end(workload):
        if m["name"] == "setup_s":
            e2e["setup_s"] = _metric(setup_s, m["unit"])
        elif m["name"] == "peak_device_mb":
            e2e["peak_device_mb"] = _metric(peak / 1e6, m["unit"])
        elif m["name"] in obs["e2e"]:
            e2e[m["name"]] = _metric(obs["e2e"][m["name"]], m["unit"])
    metrics = e2e
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": bool(ok and failed == 0),
           "attempted": int(obs["attempted"]), "failed": int(failed)}
    if trace:
        td = obs.get("trace")
        metrics = {}
        for m in spec.per_layer(workload):
            v = spec.reader(m["name"]).read(obs, ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = _metric(v, m["unit"])
        if td is not None:
            dev["busy_s"], dev["window_s"] = td.busy_s, td.window_s
            out["breakdown"] = {"device_ops": td.top_ops,
                                "idle_gaps": td.idle_gaps}
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out


def check_lines(result: dict) -> List[str]:
    """The numbers compared, each beside its limit: a run's last lines on
    standard error."""
    return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
            for n, c in result["checks"].items()]
