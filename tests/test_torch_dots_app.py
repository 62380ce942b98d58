"""The port's dots app (``tensor_ops_tpu_torch.apps.dots``) against the
JAX package's ``apps/dots.py``: the NumPy oracle draws the same network
from one seed in both packages and renders the same raster (timing lines
excluded); the torch backend passes the app's own cross-backend check
(``tests/test_apps.py``: at least 20 of 21 raster rows agree with the
oracle's) in float32 on the CPU, and renders the oracle's raster exactly in
float64."""

import contextlib
import io
import re

import pytest
import torch

import apps.dots as jdots
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.apps import dots
from torch_threads import one_torch_thread  # noqa: F401

# 6,000 samples at rate 2 from seed 3: enough training that the raster is
# not blank (the default 50,000 take minutes on the per-sample oracle)
ARGS = ["-s", "6000", "-r", "2", "--seed", "3"]


def run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def rasters(out):
    lines = out.splitlines()
    starts = [i for i, l in enumerate(lines) if l.startswith("Training ")]
    ends = starts[1:] + [len(lines)]
    return [[l for l in lines[a:b] if len(l) == 51]
            for a, b in zip(starts, ends)]


def untimed(out):
    return re.sub(r"\(\d+\.\d+s\)", "(Xs)", out)


@pytest.fixture(scope="module")
def oracle_out():
    return run_cli(dots.main, ARGS + ["np"])


def test_oracle_render_matches_jax_app(oracle_out):
    want = run_cli(jdots.main, ARGS + ["np"])
    assert untimed(oracle_out) == untimed(want)
    (raster,) = rasters(oracle_out)
    assert len(raster) == 21 and any(l.strip() for l in raster)


def test_torch_cross_backend_check(oracle_out):
    out = run_cli(dots.main, ARGS + ["b", "--device", "cpu"])
    assert "Training PyTorch network" in out
    (want,), (got,) = rasters(oracle_out), rasters(out)
    assert len(got) == 21
    same = sum(a == b for a, b in zip(got, want))
    assert same >= 20, f"only {same}/21 raster rows agree"


def test_torch_f64_renders_the_oracle_raster(oracle_out, monkeypatch):
    monkeypatch.setattr(dots, "make_backend",
                        lambda name, device: TorchBackend(torch.float64, "cpu"))
    got = dots.net_test("torch", 2.0, 6000, [12, 8], 3)
    assert got.splitlines() == rasters(oracle_out)[0]


def test_minibatch_path_and_aliases():
    out = run_cli(dots.main, ["-s", "300", "--minibatch", "50", "--seed", "1",
                              "nl", "nv", "torch", "--device", "cpu"])
    assert out.count("Training ") == 2  # nl and nv are one backend
    assert all(len(r) == 21 for r in rasters(out))


def test_rejects_unknown_backend_before_training():
    with pytest.raises(SystemExit):
        run_cli(dots.main, ["np", "jax"])
