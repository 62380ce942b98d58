"""The port's mnist app end to end on the CPU (``--device cpu``), on small
workloads: the counterparts of the JAX app's tests (``tests/test_apps.py``).

The loader's download is replaced by one that fails at once, so every test
runs on the deterministic synthetic set, as an offline machine does."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.apps import mnist
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import act_logistic, act_softmax, gen_net
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.utils import checkpoint, mnist_data


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    def refuse(url, timeout=20.0):
        raise OSError("offline")

    monkeypatch.setattr(mnist_data, "_fetch", refuse)


def run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mnist.main(argv + ["--device", "cpu"])
    return buf.getvalue()


def training_errors(out):
    return [float(l.split()[1].rstrip("%")) for l in out.splitlines()
            if l.startswith("Training:")]


def test_mnist_cli_one_batch(tmp_path):
    out = run_cli(["--epochs", "1", "--limit", "300", "-b", "300",
                   "--minibatch", "50", "-r", "0.2", "-d", str(tmp_path)])
    assert "SYNTHETIC" in out and "Loaded data." in out
    assert "Training:" in out and "Validation:" in out
    assert "[ 0]" in out  # confusion matrix rendered
    rows = [l for l in out.splitlines() if re.match(r"\[ ?\d+\] ", l)]
    assert len(rows) == 10
    assert sum(int(v) for r in rows for v in r.split()[2:]) == 1000


def test_mnist_cli_white_and_noconfusion(tmp_path):
    out = run_cli(["--epochs", "1", "--limit", "200", "-b", "220",
                   "--minibatch", "50", "-r", "0.2", "-d", str(tmp_path),
                   "-w", "-c"])
    assert "white noise class enabled" in out
    assert "[ 0]" not in out  # confusion disabled
    assert "Training on 220 samples" in out  # 200 + 10% noise rows


@pytest.mark.parametrize("argv", [["-i", "11"], ["-i", "10"],
                                  ["-i", "-1", "-w"], ["-i", "11", "-w"]])
def test_mnist_cli_induce_out_of_range(tmp_path, argv):
    with pytest.raises(SystemExit):
        run_cli(argv + ["-d", str(tmp_path)])


def test_mnist_induce_range_honors_white_class(tmp_path):
    """-w adds class 10, so -i 10 is valid with -w: the induced digit is
    rendered (28 rows of 56 characters) with its 11 class probabilities."""
    out = run_cli(["--epochs", "1", "--limit", "100", "-b", "110",
                   "--minibatch", "50", "-r", "0.2", "-d", str(tmp_path),
                   "-w", "-c", "-i", "10", "-l", "16"])
    assert "inducing: 10" in out
    lines = out.splitlines()
    probs = lines[-1].split("/")
    # 11 values printed to 2 decimals: each off by up to 0.005
    assert len(probs) == 11 and abs(sum(map(float, probs)) - 1) <= 0.056
    assert all(len(l) == 56 for l in lines[-29:-1])


@pytest.mark.parametrize("argv", [["--fused"], ["--fused", "--minibatch", "1"]])
def test_mnist_fused_requires_minibatch(tmp_path, argv):
    with pytest.raises(SystemExit):
        run_cli(argv + ["-d", str(tmp_path)])


def test_mnist_cuda_device_refused_without_cuda(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        mnist.main(["-d", str(tmp_path), "--device", "cuda"])
    assert "CUDA is not available" in capsys.readouterr().err


def test_mnist_cli_fused_whole_step_kernel(tmp_path):
    K.reset_launch_counts()
    out = run_cli(["--epochs", "1", "--limit", "400", "-b", "400",
                   "--minibatch", "100", "--fused", "-r", "0.3", "-d",
                   str(tmp_path), "-c"])
    assert "Training:" in out and "Validation:" in out
    assert K.launch_counts()["fused_mlp_train_step"] == 0  # CPU: plain step


def test_fused_and_minibatch_routes_train_alike(tmp_path):
    """The whole-step route and the vmapped IR route take the same SGD
    steps (mean cross-entropy gradient), so they print the same errors."""
    args = ["--epochs", "1", "--limit", "300", "-b", "100", "--minibatch",
            "50", "-r", "0.3", "-d", str(tmp_path), "-c", "-l", "20"]
    assert training_errors(run_cli(args + ["--fused"])) == \
        training_errors(run_cli(args))


def test_per_sample_route_trains_and_checkpoints(tmp_path):
    """Without --minibatch the app folds per-sample SGD steps, like the
    reference; the checkpoint it writes holds the fold's parameters."""
    ck = str(tmp_path / "net.npz")
    out = run_cli(["--epochs", "1", "--limit", "40", "-b", "40", "-r", "0.5",
                   "-d", str(tmp_path), "-c", "-l", "16", "--seed", "4",
                   "--checkpoint", ck])
    assert len(training_errors(out)) == 1
    be = TorchBackend(torch.float32, "cpu")
    tmpl = gen_net(be, 784, 10, [(16, act_logistic())], act_softmax(),
                   Rng(be, 0))
    saved = checkpoint.load_network(ck, tmpl, be)
    start = gen_net(be, 784, 10, [(16, act_logistic())], act_softmax(),
                    Rng(be, 4))
    assert not all(torch.equal(a, b) for a, b in zip(saved.params,
                                                     start.params))
    assert checkpoint.load_meta(ck)["acts"] == ["logistic", "softmax"]


def test_training_error_decreases(tmp_path):
    out = run_cli(["--epochs", "1", "--limit", "2000", "-b", "1000",
                   "--minibatch", "100", "-r", "0.2", "-d", str(tmp_path),
                   "-c"])
    errs = training_errors(out)
    assert len(errs) >= 2 and errs[-1] < errs[0]


def test_mnist_seed_determinism(tmp_path):
    args = ["--epochs", "1", "--limit", "200", "-b", "200", "--minibatch",
            "50", "-r", "0.2", "-d", str(tmp_path), "-c", "--seed", "3"]
    strip = lambda s: re.sub(r"in \d+\.\d+s", "in Xs", s)
    assert strip(run_cli(args)) == strip(run_cli(args))


def test_metrics_and_checkpoint(tmp_path):
    import json

    log = tmp_path / "m.jsonl"
    run_cli(["--epochs", "1", "--limit", "200", "-b", "100", "--minibatch",
             "50", "-d", str(tmp_path), "-c", "-l", "8", "--metrics",
             str(log), "--checkpoint", str(tmp_path / "c.npz")])
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(0 <= r["train_err"] <= 1 and r["batch_seconds"] > 0
               for r in recs)
    arrays, meta = checkpoint.load_arrays(str(tmp_path / "c.npz"))
    assert meta["kind"] == "feedforward" and len(arrays) == 4
    assert np.asarray(arrays["param_0"]).shape == (8, 784)
