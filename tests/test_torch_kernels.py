"""The port's kernel wrappers, on the CPU, against the JAX package's Pallas
kernels run in interpret mode at ``precision="highest"``.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
themselves are checked against the same plain versions on the card by
``chip_smoke.py``).  Inputs are numpy arrays from a seed, cast to f32 for
both packages; at the flagship widths they are pixel-like (uniform in
[0, 1)) and the weights have a trained net's 1/sqrt(fan-in) scale.
Tolerances: 1e-6 at the ``tests/test_pallas.py`` shapes (as there); 1e-5
at the flagship widths, whose 784-long f32 sums are added in another order;
1e-5 for gradients (as ``test_pallas.py:49-64``)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_ops_tpu.ops import pallas_kernels as PK
from tensor_ops_tpu.testing import rand as r
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.ops.cuda_build import CSRC_DIR

ACTS = ("identity", "logistic", "relu", "tanh")
FLAGSHIP = (784, 300, 100, 10)


def f32(a):
    return np.asarray(a, dtype=np.float32)


def t(a, requires_grad=False):
    return torch.tensor(f32(a), requires_grad=requires_grad)


def j(a):
    return jnp.asarray(f32(a), dtype=jnp.float32)


def close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def pixels(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, size=shape)


LINEAR_CASES = [
    # (batch, in, out, atol): test_pallas.py shapes, then the flagship's
    # three layers at serving batch 8
    (16, 48, 24, 1e-6),
    (7, 13, 5, 1e-6),
    (8, 784, 300, 1e-5),
    (8, 300, 100, 1e-5),
    (8, 100, 10, 1e-5),
]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("B,i,o,atol", LINEAR_CASES)
def test_fused_linear_matches_pallas(B, i, o, atol, act):
    if atol < 1e-5:  # the test_pallas.py inputs
        x, w, b = r(0, B, i), r(1, o, i) * 0.2, r(2, o)
    else:
        x, w, b = pixels(0, B, i), r(1, o, i) / np.sqrt(i), r(2, o)
    want = PK.fused_linear(j(x), j(w), j(b), act, "highest")
    got = K.fused_linear(t(x), t(w), t(b), act, "highest")
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, o)
    close(got, want, atol)
    close(K.fused_linear_ref(t(x), t(w), t(b), act), want, atol)


def test_fused_linear_ref_save_z():
    x, w, b = r(3, 6, 9), r(4, 5, 9), r(5, 5)
    y, z = K.fused_linear_ref(t(x), t(w), t(b), "tanh", save_z=True)
    assert z.dtype == torch.float32
    close(z, f32(x) @ f32(w).T + f32(b), 1e-6)
    close(y, np.tanh(z.numpy()), 1e-7)


def test_fused_linear_bf16_operands_stay_bf16():
    x, w, b = r(6, 4, 16), r(7, 3, 16), r(8, 3)
    xb = t(x).to(torch.bfloat16)
    got = K.fused_linear(xb, t(w).to(torch.bfloat16), t(b), "relu")
    assert got.dtype == torch.bfloat16
    want = PK.fused_linear(j(x).astype(jnp.bfloat16),
                           j(w).astype(jnp.bfloat16), j(b), "relu",
                           "highest")
    close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-2)


def within_bf16_ulps(got, want, ulps):
    """|got - want| <= ulps bf16 ulps of |want| (at least of the smallest
    normal), elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))))
    return bool((np.abs(got - want) <= ulps * scale * 2.0 ** -7).all())


@pytest.mark.parametrize("act", ACTS)
def test_fused_linear_bf16_values_and_grads_match_jax(act):
    """bf16 x and w with an f32 bias against the JAX kernel (interpret
    mode) and its custom VJP (``tests/test_pallas.py:406-418``): y bf16
    within one bf16 ulp; dx and dw bf16, db f32, each within two bf16 ulps
    (their f32 sums are rounded to bf16 after summing in another order)."""
    x, w, b = r(60, 8, 16), r(61, 4, 16) * 0.2, r(62, 4) * 0.1
    jx, jw = j(x).astype(jnp.bfloat16), j(w).astype(jnp.bfloat16)

    def jloss(x, w, b):
        return jnp.sum(PK.fused_linear(x, w, b, act, "highest")
                       .astype(jnp.float32) ** 2)

    want_y = PK.fused_linear(jx, jw, j(b), act, "highest")
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jx, jw, j(b))
    tx = t(x).to(torch.bfloat16).requires_grad_()
    tw = t(w).to(torch.bfloat16).requires_grad_()
    tbias = t(b, True)
    y = K.fused_linear(tx, tw, tbias, act, "highest")
    assert y.dtype == torch.bfloat16
    assert within_bf16_ulps(y.detach().float().numpy(),
                            np.asarray(want_y.astype(jnp.float32)), 1)
    (y.float() ** 2).sum().backward()
    assert (tx.grad.dtype, tw.grad.dtype, tbias.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32)
    for got, wnt in zip((tx.grad, tw.grad, tbias.grad), want_g):
        assert within_bf16_ulps(got.float().numpy(),
                                np.asarray(wnt.astype(jnp.float32)), 2)


@pytest.mark.parametrize("act", ACTS)
def test_fused_linear_grads_match_jax(act):
    """Autograd through the port's ``torch.autograd.Function`` against
    ``jax.grad`` through the Pallas kernel's custom VJP."""
    x, w, b = r(6, 8, 20), r(7, 12, 20) * 0.2, r(8, 12)

    def jloss(x, w, b):
        return jnp.sum(PK.fused_linear(x, w, b, act, "highest") ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(j(x), j(w), j(b))
    tx, tw, tbias = t(x, True), t(w, True), t(b, True)
    (K.fused_linear(tx, tw, tbias, act, "highest") ** 2).sum().backward()
    for got, wnt in zip((tx.grad, tw.grad, tbias.grad), want):
        close(got, np.asarray(wnt), 1e-5)


def test_fused_linear_grads_match_autograd_of_ref():
    """The hand-written backward == autograd of the plain forward."""
    x, w, b = r(9, 5, 7), r(10, 4, 7), r(11, 4)
    grads = []
    for fn in (lambda *a: K.fused_linear(*a, "logistic"),
               lambda *a: K.fused_linear_ref(*a, "logistic")):
        ts = (t(x, True), t(w, True), t(b, True))
        fn(*ts).pow(3).sum().backward()
        grads.append([v.grad for v in ts])
    for g, want in zip(*grads):
        close(g, want.numpy(), 1e-6)


MLP_CASES = [
    # (batch, widths, hidden acts, softmax_out, atol)
    (10, (30, 20, 6), ("logistic",), True, 1e-6),
    (10, (30, 20, 6), ("tanh",), False, 1e-6),
    (5, (13, 9, 7, 3), ("relu", "logistic"), True, 1e-6),
    (8, FLAGSHIP, ("logistic", "logistic"), True, 1e-5),
    (8, FLAGSHIP, ("logistic", "logistic"), False, 1e-5),
]


@pytest.mark.parametrize("B,dims,hidden,softmax_out,atol", MLP_CASES)
def test_fused_mlp_forward_matches_pallas(B, dims, hidden, softmax_out,
                                          atol):
    acts = tuple(hidden) + ("identity",)
    flagship = dims == FLAGSHIP
    x = pixels(12, B, dims[0]) if flagship else r(12, B, dims[0])
    ws = [r(20 + k, dims[k + 1], dims[k])
          * (1 / np.sqrt(dims[k]) if flagship else 0.2)
          for k in range(len(acts))]
    bs = [r(30 + k, dims[k + 1]) for k in range(len(acts))]
    want = PK.fused_mlp_forward(j(x), [j(w) for w in ws], [j(b) for b in bs],
                                acts, softmax_out=softmax_out,
                                precision="highest")
    got = K.fused_mlp_forward(t(x), [t(w) for w in ws], [t(b) for b in bs],
                              acts, softmax_out, precision="highest")
    assert tuple(got.shape) == (B, dims[-1])
    close(got, np.asarray(want), atol)
    if softmax_out:
        close(got.sum(dim=1), np.ones(B), 1e-6)


def test_fused_mlp_forward_bf16_weights_read_as_f32():
    x = r(13, 4, 12)
    ws, bs = [r(14, 6, 12), r(15, 3, 6)], [r(16, 6), r(17, 3)]
    acts = ("relu", "identity")
    full = K.fused_mlp_forward(t(x), [t(w) for w in ws], [t(b) for b in bs],
                               acts)
    half = K.fused_mlp_forward(
        t(x), [t(w).to(torch.bfloat16) for w in ws],
        [t(b).to(torch.bfloat16) for b in bs], acts)
    assert half.dtype == torch.float32
    close(half, full.numpy(), 5e-2)


def test_cpu_path_launches_no_kernel():
    K.reset_launch_counts()
    x, w, b = t(r(18, 3, 4)), t(r(19, 2, 4)), t(r(20, 2))
    K.fused_linear(x, w, b, "tanh")
    K.fused_mlp_forward(x, [w], [b], ["identity"])
    assert K.launch_counts() == {"fused_linear": 0, "fused_mlp_forward": 0,
                                 "fused_mlp_train_step": 0,
                                 "fused_linear_w8": 0, "fused_linear_w8a8": 0,
                                 "fused_mlp_w8a8_forward": 0,
                                 "fused_rnn_step": 0, "ring_all_reduce": 0,
                                 "bidir_ring": 0, "ring_all_reduce.ring": 0,
                                 "bidir_ring.ring": 0}


def test_names_are_validated():
    x, w, b = t(r(21, 3, 4)), t(r(22, 2, 4)), t(r(23, 2))
    with pytest.raises(ValueError, match="activation"):
        K.fused_linear(x, w, b, "gelu")
    with pytest.raises(ValueError, match="precision"):
        K.fused_linear(x, w, b, "relu", "fast")
    with pytest.raises(ValueError, match="one weight"):
        K.fused_mlp_forward(x, [w], [b, b], ["relu"])


@pytest.mark.parametrize("B,K_,O,instance,vec,rows,grid", [
    # the flagship's layers at the main path's batches
    (1, 784, 300, "gemv", True, 1, (75, 1, 1)),
    (8, 784, 300, "gemv", True, 8, (75, 1, 1)),
    (8, 100, 10, "gemv", True, 8, (3, 1, 1)),      # the identity layer
    (16, 784, 300, "gemv", True, 16, (75, 1, 1)),
    (17, 784, 300, "tile", True, 32, (5, 1, 13)),
    (100, 784, 300, "tile", True, 32, (5, 4, 7)),
    (100, 300, 100, "tile", True, 32, (2, 4, 5)),
    (100, 100, 10, "tile", True, 32, (1, 4, 2)),
    (512, 784, 300, "tile", True, 32, (5, 16, 2)),
    (4096, 4096, 4096, "large", True, 128, (32, 32, 1)),
    # K % 4 != 0: the same instance with scalar loads
    (100, 783, 300, "tile", False, 32, (5, 4, 7)),
    (7, 13, 5, "gemv", False, 8, (2, 1, 1)),
])
def test_linear_plan_picks_the_instance(B, K_, O, instance, vec, rows, grid):
    for dtype in (torch.float32, torch.bfloat16):
        plan = K.linear_plan(B, K_, O, dtype)
        assert (plan.instance, plan.vec, plan.rows, plan.grid) == (
            instance, vec, rows, grid)
        assert plan.block == K.LINEAR_INSTANCES[instance][2]


def test_linear_plan_unaligned_operands_load_scalars():
    assert K.linear_plan(100, 784, 300).vec
    assert not K.linear_plan(100, 784, 300, aligned=False).vec


@pytest.mark.parametrize("B,K_,O", [
    (100, 784, 300), (100, 300, 100), (100, 100, 10), (17, 784, 300),
    (512, 784, 300), (100, 783, 300), (33, 40, 10), (200, 64, 64),
])
def test_linear_plan_split_covers_k_once(B, K_, O):
    """Each split walks kchunk k (a multiple of 16, at least 64), the splits
    cover K with no empty one, the grid covers the output once, and the
    partials' scratch is split x B x O floats."""
    p = K.linear_plan(B, K_, O)
    gx, gy, gz = p.grid
    assert gz == p.split and gx * 64 >= O and gy * 32 >= B
    if p.split > 1:
        assert p.kchunk % 16 == 0 and p.kchunk >= K.SPLIT_MIN_K
        assert (p.split - 1) * p.kchunk < K_ <= p.split * p.kchunk
        assert p.scratch_floats == p.split * B * O
        assert gx * gy * (p.split - 1) < K.H100_SMS  # no more than fills SMs
    else:
        assert p.scratch_floats == 0 and p.kchunk >= K_


def test_linear_plan_flagship_layers_fill_the_card_at_batch_100():
    """The training forward's first layer: 20 tiles split 7 ways, 140
    blocks on the 132 SMs (the design before ran 2 x 5 blocks)."""
    p = K.linear_plan(100, 784, 300)
    assert p.split == 7 and p.kchunk == 112
    assert p.grid[0] * p.grid[1] * p.grid[2] == 140


def _cu_tile(source: str, name: str):
    """(BM, BN, BK, threads) of ``using <name> = ...Tile<BM, BN, BK, TM, TN
    [, KS]>;`` in ``csrc/<source>``."""
    text = (CSRC_DIR / source).read_text()
    m = re.search(rf"using {name} = (?:simt::)?Tile<([\d,\s]+)>;", text)
    assert m, f"{name} not found in {source}"
    bm, bn, bk, tm, tn, *ks = map(int, m.group(1).split(","))
    return bm, bn, bk, (bm // tm) * (bn // tn) * (ks[0] if ks else 1)


def _cu_int(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC_DIR / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("what", ["tile", "large", "gemv", "gemv_rows",
                                  "train_tile", "train_layers"])
def test_host_geometry_matches_the_kernel_sources(what):
    """The host's copy of each kernel's tile shapes (which the plans and
    scratch sizes are computed from) equals the constants in its source."""
    if what in ("tile", "large"):
        tile = {"tile": "MidTile", "large": "LargeTile"}[what]
        _, shape, threads = K.LINEAR_INSTANCES[what]
        assert _cu_tile("fused_linear.cu", tile) == (*shape, threads)
    elif what == "gemv":
        warps = _cu_int("fused_linear.cu", "kGemvWarps")
        assert warps == K.GEMV_WARPS
        assert 32 * warps == K.LINEAR_INSTANCES["gemv"][2]
    elif what == "gemv_rows":
        text = (CSRC_DIR / "fused_linear.cu").read_text()
        rows = tuple(int(r) for r in re.findall(
            r"case (\d+): launch_gemv<T, \1>", text))
        assert rows == K.GEMV_ROWS
    elif what == "train_tile":
        bm, bn, _, threads = _cu_tile("fused_mlp_train_step.cu", "StepTile")
        assert (bm, bn, threads) == (K.TRAIN_TILE, K.TRAIN_TILE,
                                     K.TRAIN_THREADS)
    else:
        assert _cu_int("fused_mlp_train_step.cu", "kMaxLayers") == K.MAX_LAYERS


def test_linear_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.linear_plan(8, 4, 4, torch.float64)
    with pytest.raises(ValueError, match="row tiles"):
        K.linear_plan(128 * 65536, 8, 8)


@pytest.mark.parametrize("batch,widths,want", [
    (8, FLAGSHIP, 8),
    (63, FLAGSHIP, 32),
    (1000, FLAGSHIP, 32),
    (5, (33, 20, 7), 5),
    (64, (14000, 10), 2),   # 2 rows x 2 buffers x 14001 floats fit
    (64, (20000, 10), 1),
])
def test_tile_rows_fits_shared_memory(batch, widths, want):
    rows = K.tile_rows(batch, widths)
    assert rows == want
    stride = max(widths) | 1
    assert 2 * rows * stride * 4 <= K.MAX_SMEM_BYTES


def test_tile_rows_names_a_width_too_wide():
    with pytest.raises(ValueError, match="30000"):
        K.tile_rows(4, (30000, 10))
