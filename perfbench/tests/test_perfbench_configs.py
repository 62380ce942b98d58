"""Each configuration's plain reference against ``tensor_ops_tpu_torch``
at a small size on the CPU in float64, and each work count against a hand
count at the published widths."""

import copy

import pytest
import torch

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.models import training

BE = TorchBackend(torch.float64, "cpu")


def small_mlp(spec):
    cfg = copy.deepcopy(spec.config_file("mnist-mlp"))
    cfg.update(**{"in": 12}, hidden=[[7, "logistic"], [5, "logistic"]])
    cfg["out"] = [4, "softmax"]
    cfg["data"].update(classes=4, pixels=12)
    return cfg


def small_elman(spec):
    cfg = copy.deepcopy(spec.config_file("elman-512"))
    cfg.update(**{"in": 3}, hidden=[[6, "logistic", "logistic"]])
    cfg["out"] = [2, "logistic"]
    return cfg


def leaves(ref, cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return [t.double() for t in ref.make_params(cfg, g, "cpu")]


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_reference_matches_the_program(spec, seed):
    ref, fam = spec.reference("mnist-mlp"), spec.family("feedforward")
    cfg = small_mlp(spec)
    ls = leaves(ref, cfg, seed)
    g = torch.Generator().manual_seed(seed + 10)
    d = ref.make_data(cfg, g, "cpu", train_rows=9, test_rows=3)
    X, Y = d["X"].double(), d["Y"].double()
    net = fam.build(cfg, BE, ls)
    out = training.batched_run(net, BE)(X, *net.params)
    assert torch.allclose(out, ref.forward(cfg, ls, X, "f64"), atol=1e-12)
    v, grads = training.make_mean_grads(net, fam.loss(cfg), BE)(
        X, Y, *net.params)
    rl = [t.clone().requires_grad_(True) for t in ls]
    L = ref.loss(cfg, rl, (X, Y), "f64")
    rg = torch.autograd.grad(L, rl)
    assert abs(float(v) - float(L.detach())) < 1e-12
    for a, b in zip(grads, rg):
        assert torch.allclose(a, b, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_elman_reference_matches_the_program(spec, seed):
    ref, fam = spec.reference("elman-512"), spec.family("recurrent")
    cfg = small_elman(spec)
    ls = leaves(ref, cfg, seed)
    g = torch.Generator().manual_seed(seed + 10)
    d = ref.make_data(cfg, g, "cpu", sequences=4, length=5)
    X, Y = d["X"].double(), d["Y"].double()
    rnet = fam.build(cfg, BE, ls)
    want = ref.forward(cfg, ls, X, "f64")
    for b in range(X.shape[0]):
        ys, _ = rnet.run_seq(BE, X[b])
        assert torch.allclose(ys, want[b], atol=1e-12)
    k = len(rnet.states)
    v, grads = training.make_seq_mean_grads(rnet, fam.loss(cfg), BE, 5)(
        X, Y, tuple(rnet.states) + tuple(rnet.params))
    rl = [t.clone().requires_grad_(True) for t in ls]
    L = ref.loss(cfg, rl, (X, Y), "f64")
    rg = torch.autograd.grad(L, rl)
    assert abs(float(v) - float(L.detach())) < 1e-10
    assert len(grads) == len(rg) == k + len(rnet.params)
    for a, b in zip(grads, rg):
        assert torch.allclose(a, b, atol=1e-10)


def test_mlp_work_count_by_hand(spec):
    ref, cfg = spec.reference("mnist-mlp"), spec.config_file("mnist-mlp")
    weights = 784 * 300 + 300 * 100 + 100 * 10
    assert weights == 266_200
    assert ref.work(cfg, "forward")["flops"] == 532_400
    # forward, weight gradients, and the input gradients of layers 2 and 3
    train = ref.work(cfg, "train_step", rows=100, optimizer="adam")
    assert train["flops"] == 100 * (2 * 532_400 + 2 * (30_000 + 1_000))
    params = weights + 300 + 100 + 10
    assert train["bytes"] == 4 * (100 * (784 + 10) + 2 * params * 3)


def test_elman_work_count_by_hand(spec):
    ref, cfg = spec.reference("elman-512"), spec.config_file("elman-512")
    per_step = 2 * (512 * 512 + 512 * 32 + 32 * 512)
    assert per_step == 589_824
    assert ref.work(cfg, "forward", rows=1, steps=1)["flops"] == 589_824
    f = ref.work(cfg, "train_step", rows=256)["flops"]
    assert f == 256 * 64 * (2 * per_step + 2 * 512 * 512 + 2 * 32 * 512)


@pytest.mark.parametrize("config", ["mnist-mlp", "elman-512"])
def test_tf32_rounding_is_to_nearest_tf32(spec, config):
    from perfbench.precision import to_tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 + 2**-20],
                     dtype=torch.float32)
    r = to_tf32(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2**-10, -3.0]
    ls = leaves(spec.reference(config), spec.config_file(config), 0)
    for t in ls:
        q = to_tf32(t.float())
        assert float((q - t.float()).abs().max()) <= \
            float(t.float().abs().max()) * 2**-11
