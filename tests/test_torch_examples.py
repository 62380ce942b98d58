"""The port's example scripts run end to end on the CPU, each as a
subprocess (as ``tests/test_examples.py`` runs the JAX package's), so
that a change of the API breaks a test, not a user.  Each example is
``python -m tensor_ops_tpu_torch.examples.<name> --device cpu``; on the
card the default device (cuda) runs them."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", f"tensor_ops_tpu_torch.examples.{module}",
         "--device", "cpu", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (f"{module} failed:\n{r.stdout[-3000:]}\n"
                               f"{r.stderr[-3000:]}")
    return r.stdout


def test_recurrent_sine_runs():
    """The Elman demo: the sequence loss falls over 300 BPTT steps, and the
    trained net rolls forward step by step."""
    out = _run("recurrent_sine")
    line = next(x for x in out.splitlines() if x.startswith("loss "))
    first, last = line[len("loss "):].split(" -> ")
    assert float(last) < float(first)
    assert "first 10 predictions:" in out and "first 10 targets:" in out


def test_production_fit_runs(tmp_path):
    """The training-to-serving journey: fit with adamw, a cosine schedule,
    clipping and EMA; a crash and a resume to the full budget; the EMA net
    served in int8 above 90% accuracy; the artifacts in the workdir."""
    out = _run("production_fit", "--workdir", str(tmp_path))
    assert "== phase 2: resume to the full budget ==" in out
    assert "resumed from" in out
    acc = float(out.split("served int8 accuracy ")[1].split()[0])
    assert acc > 0.9
    for name in ("model.npz", "model.npz.state", "metrics.jsonl"):
        assert os.path.exists(tmp_path / name)
    with open(tmp_path / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps[-1] == 8 * (2048 // 64)


@pytest.mark.parametrize("module", ["recurrent_sine", "production_fit"])
def test_examples_refuse_a_missing_card(module):
    """Without ``--device cpu`` an example runs on cuda; with no card it
    fails instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", f"tensor_ops_tpu_torch.examples.{module}"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0


def test_plan_and_budget_runs():
    """The operator's pre-flight on CPU ranks at a small batch: the ranked
    meshes, the budget rows per optimizer and ZeRO, the forward's measured
    bytes (its arguments X and the parameters, its output B x 10 f32) and
    one fit step on the winner."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "tensor_ops_tpu_torch.examples.plan_and_budget",
         "--cpu", "--batch", "64"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout
    assert "analytic winner: (dp=" in out
    assert out.count("zero1=") == 4
    params = (784 * 300 + 300 + 300 * 100 + 100 + 100 * 10 + 10) * 4
    line = next(x for x in out.splitlines() if x.startswith("  arguments"))
    assert line.split()[1] == f"{(64 * 784 * 4 + params) / 1e6:.2f}"
    assert line.split()[4] == f"{64 * 10 * 4 / 1e6:.2f}"
    loss = float(out.split("step loss: ")[1].split()[0])
    assert np.isfinite(loss)
