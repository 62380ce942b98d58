"""The port's int8 quantizers and int8 kernel wrappers, on the CPU, against
the JAX package's (Pallas in interpret mode, as ``tests/test_pallas.py``
runs them).

On the CPU each wrapper takes its plain PyTorch version; ``chip_smoke.py``
holds the CUDA kernels to the same plain versions on the card.

Tolerances, with their reasons:

* Codes and scales compare exactly: both packages divide by IEEE division
  and round half to even.
* ``fused_linear_w8a8``: the int32 sum is exact in both packages, but XLA on
  the CPU fuses the epilogue's last multiply and add into one FMA, while the
  port rounds ``(acc * sx) * sw`` before adding ``b`` (the kernel's op order,
  which keeps it bit-equal to its plain version).  So each value may differ
  by one f32 ulp of ``acc * sx * sw`` plus one of the result; against the
  same op order computed in numpy the port is exact.  An activation after it
  (slope <= 1) passes that on and adds up to 4 ulps of its own output:
  torch and XLA compute exp and tanh by other formulas.
* ``fused_linear_w8``: the same bf16-rounded (or f32) operands, products
  summed in another order: 1e-6 at widths up to 40, 1e-5 at 257 and 784
  (the flagship tolerance of ``test_torch_kernels.py``).
* The whole int8 MLP: each layer adds the one-ulp epilogue difference above.
  Where such a difference moves a hidden value across a .5 code boundary one
  code of the next layer flips, which moves a logit by up to
  ``sx * max|w|`` of that layer; at these seeds no code flips, and the
  outputs agree to 1e-5 (the JAX test holds its own chain to 1e-4).  The
  port's whole-MLP route equals its per-layer chain bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_ops_tpu.ops import pallas_kernels as PK
from tensor_ops_tpu.testing import rand as r
from tensor_ops_tpu_torch.ops import kernels as K
from torch_threads import one_torch_thread  # noqa: F401


def f32(a):
    return np.asarray(a, dtype=np.float32)


def t(a):
    return torch.tensor(np.asarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def jax_quantized_layer(seed, B, o, i, w_scale=0.3, b_scale=0.1):
    """x, f32 weights and biases from numpy, and the JAX package's codes."""
    x = f32(r(seed, B, i))
    w = f32(r(seed + 1, o, i) * w_scale)
    b = f32(r(seed + 2, o) * b_scale)
    q, s = PK.quantize_weights_int8(j(w))
    return x, w, b, np.asarray(q), np.asarray(s)


def epilogue_ulps(x, q, s, z):
    """Per element, one f32 ulp of ``(acc * sx) * sw`` plus one of the
    pre-activation ``z``: the most the FMA in the JAX epilogue can move a
    value from the port's separately rounded one."""
    xq, sx = K.quantize_acts_int8(t(x))
    acc = (xq.double() @ t(q).double().T).float().numpy()
    prod = (acc * sx.numpy()) * f32(s).reshape(1, -1)
    return (np.spacing(np.abs(prod).astype(np.float32))
            + np.spacing(np.abs(z).astype(np.float32)))


QUANT_SHAPES = [(6, 10, 0.7), (33, 257, 0.3), (5, 128, 1.0), (1, 16, 3.0)]


@pytest.mark.parametrize("rows,cols,scale", QUANT_SHAPES)
@pytest.mark.parametrize("which", ["weights", "acts"])
def test_quantizers_match_jax_bit_for_bit(rows, cols, scale, which):
    a = f32(r(rows + cols, rows, cols) * scale)
    a[rows // 2] = 0.0  # an all-zero row (bucket padding): scale 1, codes 0
    jq, js = getattr(PK, f"quantize_{which}_int8")(j(a))
    tq, ts = getattr(K, f"quantize_{which}_int8")(t(a))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (rows, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[rows // 2].item() == 1.0 and not tq[rows // 2].any()


def test_quantizer_rounds_half_to_even():
    # with amax 127 the scale is 1, so x / s lands exactly on .5 values
    x = f32([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]])
    want = np.array([[127, 0, 2, 2, 0, -2, -2, 126]], np.int8)
    np.testing.assert_array_equal(K.quantize_acts_int8(t(x))[0].numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(PK.quantize_acts_int8(j(x))[0]),
                                  want)


def test_weight_quantization_error_is_half_a_step():
    """Counterpart of ``test_pallas.py:163-173``."""
    w = f32(r(20, 6, 10) * 0.7)
    q, s = K.quantize_weights_int8(t(w))
    err = np.abs(w - (q.float() * s).numpy()).max(axis=1)
    assert (err <= s.numpy()[:, 0] * 0.5 + 1e-7).all()


@pytest.mark.parametrize("k", [16, 100, 257, 300, 784])
def test_pad_codes_appends_zero_codes(k):
    q = t(np.random.default_rng(k).integers(-127, 128, size=(3, k))
          .astype(np.int8))
    p = K.pad_codes(q)
    assert p.shape[1] == K.padded_width(k) and p.shape[1] % 16 == 0
    assert torch.equal(p[:, :k], q) and not p[:, k:].any()
    assert (p is q) == (k % 16 == 0)


W8_CASES = [
    # (batch, out, in, act): test_pallas.py:176-190, odd and flagship shapes
    (8, 6, 16, "logistic"),
    (7, 5, 13, "relu"),
    (40, 130, 257, "tanh"),
    (8, 300, 784, "logistic"),
    (8, 10, 100, "identity"),
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("B,o,i,act", W8_CASES)
def test_fused_linear_w8_matches_jax(B, o, i, act, precision):
    x, _, b, q, s = jax_quantized_layer(21 + i, B, o, i)
    want = np.asarray(PK.fused_linear_w8(j(x), j(q), j(s), j(b), act,
                                         precision))
    got = K.fused_linear_w8(t(x), t(q), t(s), t(b), act, precision)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, o)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 if i <= 40 else 1e-5)
    padded = K.fused_linear_w8(t(x), K.pad_codes(t(q)), t(s), t(b), act,
                               precision)
    assert torch.equal(padded, got)


def test_fused_linear_w8_default_rounds_to_bf16():
    """At "default" x and the dequantized weight are rounded to bf16, as the
    TPU body casts them: the result differs from "highest", and equals the
    f32 product of the rounded operands."""
    x, _, b, q, s = jax_quantized_layer(30, 4, 6, 40)
    hi = K.fused_linear_w8(t(x), t(q), t(s), t(b), "identity", "highest")
    lo = K.fused_linear_w8(t(x), t(q), t(s), t(b), "identity", "default")
    assert not torch.equal(hi, lo)
    xb = t(x).to(torch.bfloat16).float()
    wb = (t(q).float() * t(s)).to(torch.bfloat16).float()
    np.testing.assert_allclose(lo.numpy(), (xb @ wb.T + t(b)).numpy(),
                               rtol=0, atol=1e-6)


def test_fused_linear_w8_close_to_full_precision():
    """Counterpart of ``test_pallas.py:176-190``: int8 weight error
    propagates mildly through logistic (0.02, as there)."""
    x, w, b, q, s = jax_quantized_layer(21, 8, 6, 16)
    y8 = K.fused_linear_w8(t(x), t(q), t(s), t(b), "logistic", "highest")
    y32 = K.fused_linear(t(x), t(w), t(b), "logistic", "highest")
    np.testing.assert_allclose(y8.numpy(), y32.numpy(), atol=0.02)


def test_fused_linear_w8a8_int32_exact():
    """Counterpart of ``test_pallas.py:212-229``: integer x with a 127 in
    every row quantizes to itself (scale 1), so the int32 path is exact."""
    rr = np.random.default_rng(7)
    x = rr.integers(-127, 128, size=(5, 12)).astype(np.float32)
    x[:, 0] = 127.0
    wq = rr.integers(-127, 128, size=(9, 12)).astype(np.int8)
    sw, b = np.ones((9, 1), np.float32), np.zeros(9, np.float32)
    want = x.astype(np.int64) @ wq.astype(np.int64).T
    got = K.fused_linear_w8a8(t(x), t(wq), t(sw), t(b), "identity")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    jax_y = PK.fused_linear_w8a8(j(x), j(wq), j(sw), j(b), "identity")
    np.testing.assert_array_equal(np.asarray(jax_y), got.numpy())


@pytest.mark.parametrize("B,o,i", [(1, 6, 16), (33, 10, 40), (40, 130, 257),
                                   (5, 128, 128), (8, 300, 784),
                                   (8, 100, 300), (8, 10, 100)])
def test_fused_linear_w8a8_matches_jax(B, o, i):
    """The odd shapes of ``test_pallas.py:505-527`` and the flagship's three
    layers at batch 8."""
    x, _, b, q, s = jax_quantized_layer(200 + B + i, B, o, i)
    want = np.asarray(PK.fused_linear_w8a8(j(x), j(q), j(s), j(b),
                                           "identity"))
    got = K.fused_linear_w8a8(t(x), t(q), t(s), t(b), "identity")
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, o)
    diff = np.abs(got.numpy() - want)
    assert (diff <= epilogue_ulps(x, q, s, want)).all(), diff.max()
    # the same math op by op in numpy: exact
    xq, sx = (a.numpy() for a in K.quantize_acts_int8(t(x)))
    acc = (xq.astype(np.int64) @ q.astype(np.int64).T).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), (acc * sx) * s.T + b)
    assert torch.equal(
        K.fused_linear_w8a8(t(x), K.pad_codes(t(q)), t(s), t(b)), got)


@pytest.mark.parametrize("act", ["logistic", "relu", "tanh"])
@pytest.mark.parametrize("B,o,i", [(8, 6, 16), (8, 300, 784)])
def test_fused_linear_w8a8_activations_match_jax(act, B, o, i):
    x, _, b, q, s = jax_quantized_layer(31 + i, B, o, i)
    want = np.asarray(PK.fused_linear_w8a8(j(x), j(q), j(s), j(b), act))
    z = np.asarray(PK.fused_linear_w8a8(j(x), j(q), j(s), j(b), "identity"))
    got = K.fused_linear_w8a8(t(x), t(q), t(s), t(b), act)
    tol = epilogue_ulps(x, q, s, z) + 4 * np.spacing(np.abs(want))
    assert (np.abs(got.numpy() - want) <= tol).all()


def uniform_stack(seed, N=128, L=3, B=5):
    ws = [f32(r(seed + k, N, N) * 0.2) for k in range(L)]
    bs = f32(np.stack([r(seed + 10 + k, N) * 0.1 for k in range(L)]))
    qs, ss = zip(*(PK.quantize_weights_int8(j(w)) for w in ws))
    wq3 = np.stack([np.asarray(q) for q in qs])
    sw2 = np.stack([np.asarray(s).reshape(-1) for s in ss])
    return f32(r(seed + 20, B, N)), wq3, sw2, bs


@pytest.mark.parametrize("act", ["relu", "identity", "logistic"])
def test_fused_mlp_w8a8_matches_jax(act):
    """Counterpart of ``test_pallas.py:232-258`` at N=128, L=3, B=5."""
    x, wq3, sw2, b2 = uniform_stack(40)
    want = np.asarray(PK.fused_mlp_w8a8_forward(j(x), j(wq3), j(sw2), j(b2),
                                                act))
    got = K.fused_mlp_w8a8_forward(t(x), t(wq3), t(sw2), t(b2), act)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "logistic"])
def test_fused_mlp_w8a8_is_the_per_layer_chain_bit_for_bit(act):
    x, wq3, sw2, b2 = uniform_stack(41)
    h = t(x)
    for l in range(len(wq3)):
        h = K.fused_linear_w8a8(h, t(wq3[l]), t(sw2[l]), t(b2[l]),
                                act if l < len(wq3) - 1 else "identity")
    got = K.fused_mlp_w8a8_forward(t(x), t(wq3), t(sw2), t(b2), act)
    assert torch.equal(got, h)


def test_fused_mlp_w8a8_zero_rows_stay_finite():
    """Bucket padding feeds all-zero rows: scale 1, codes 0, no NaN, and the
    other rows are untouched."""
    x, wq3, sw2, b2 = uniform_stack(42)
    xp = np.concatenate([x, np.zeros((3, x.shape[1]), np.float32)])
    got = K.fused_mlp_w8a8_forward(t(xp), t(wq3), t(sw2), t(b2), "relu")
    assert torch.isfinite(got).all()
    assert torch.equal(got[:len(x)], K.fused_mlp_w8a8_forward(
        t(x), t(wq3), t(sw2), t(b2), "relu"))


@pytest.mark.parametrize("bad", ["not square", "not 128", "not int8"])
def test_fused_mlp_w8a8_rejects_other_stacks(bad):
    x, wq3, sw2, b2 = uniform_stack(43)
    if bad == "not square":
        wq3 = wq3[:, :64]
    elif bad == "not 128":
        x, wq3, sw2, b2 = x[:, :96], wq3[:, :96, :96], sw2[:, :96], b2[:, :96]
    codes = t(wq3).float() if bad == "not int8" else t(wq3)
    with pytest.raises(ValueError, match="uniform 128-multiple"):
        K.fused_mlp_w8a8_forward(t(x), codes, t(sw2), t(b2), "relu")
    if bad != "not int8":  # the JAX package refuses the same shapes
        with pytest.raises(ValueError, match="uniform 128-multiple"):
            PK.fused_mlp_w8a8_forward(j(x), j(wq3), j(sw2), j(b2), "relu")


def test_int8_wrappers_validate_their_inputs():
    x, _, b, q, s = jax_quantized_layer(50, 4, 6, 20)
    with pytest.raises(ValueError, match="int8 codes"):
        K._int8_shapes("fused_linear_w8a8", t(x), t(q).float(), t(s), t(b))
    with pytest.raises(ValueError, match="disagree"):
        K._int8_shapes("fused_linear_w8", t(x), t(q)[:, :19], t(s), t(b))
    with pytest.raises(ValueError, match="activation"):
        K.fused_linear_w8a8(t(x), t(q), t(s), t(b), "gelu")
    with pytest.raises(ValueError, match="precision"):
        K.fused_linear_w8(t(x), t(q), t(s), t(b), "relu", "fast")
    assert K._int8_shapes("fused_linear_w8a8", t(x), K.pad_codes(t(q)),
                          t(s), t(b)) == (4, 20, 6)


@pytest.mark.parametrize("batch,k,nbytes,want", [
    (1, 784, 1, 1), (5, 784, 1, 8), (16, 4096, 1, 16), (512, 4096, 1, 16),
    (8, 784, 4, 8), (16, 4096, 4, 8), (16, 40000, 4, 1),
])
def test_int8_tile_rows_fit_shared_memory(batch, k, nbytes, want):
    rows = K.int8_tile_rows(batch, k, nbytes)
    assert rows == want and rows * k * nbytes <= K.MAX_SMEM_BYTES


def test_int8_tile_rows_names_a_width_too_wide():
    with pytest.raises(ValueError, match="60000"):
        K.int8_tile_rows(4, 60000, 4)


# w8_plan per shape: (B, K, O, precision) -> (instance, vec, rows, grid,
# kchunk).  The flagship's layers at the w8 buckets and the gemv's edges;
# the tiles split K where they are fewer than the SMs and a split still
# walks 128 k; the gemv splits only K of 2048 and more.
W8_PLANS = [
    (1, 784, 300, "default", "gemv", True, 1, (75, 1, 1), 784),
    (1, 100, 10, "highest", "gemv", True, 1, (3, 1, 1), 100),
    (8, 784, 300, "default", "gemv", True, 8, (75, 1, 1), 784),
    (8, 300, 100, "default", "gemv", True, 8, (25, 1, 1), 300),
    (8, 100, 10, "default", "gemv", True, 8, (3, 1, 1), 100),
    (8, 784, 300, "highest", "gemv", True, 8, (75, 1, 1), 784),
    (16, 300, 100, "default", "gemv", True, 16, (25, 1, 1), 300),
    (17, 784, 300, "default", "mma", True, 32, (10, 1, 5), 160),
    (17, 784, 300, "highest", "simt", True, 32, (5, 1, 6), 144),
    (64, 784, 300, "default", "mma", True, 32, (10, 2, 5), 160),
    (64, 300, 100, "default", "mma", True, 32, (4, 2, 2), 160),
    (64, 100, 10, "default", "mma", True, 32, (1, 2, 1), 100),
    (64, 784, 300, "highest", "simt", True, 32, (5, 2, 6), 144),
    (512, 784, 300, "default", "mma", True, 32, (10, 16, 1), 784),
    (512, 300, 100, "default", "mma", True, 32, (4, 16, 2), 160),
    (512, 100, 10, "default", "mma", True, 32, (1, 16, 1), 100),
    (512, 784, 300, "highest", "simt", True, 32, (5, 16, 2), 400),
    # ragged K (scalar loads of x), a long K split over blocks
    (5, 257, 130, "default", "gemv", False, 8, (33, 1, 1), 257),
    (40, 257, 130, "default", "mma", False, 32, (5, 2, 2), 160),
    (40, 257, 130, "highest", "simt", False, 32, (3, 2, 2), 144),
    (8, 4096, 64, "default", "gemv", True, 8, (16, 1, 4), 1024),
]


@pytest.mark.parametrize("B,K_,O,precision,instance,vec,rows,grid,kchunk",
                         W8_PLANS)
def test_w8_plan_per_shape(B, K_, O, precision, instance, vec, rows, grid,
                           kchunk):
    plan = K.w8_plan(B, K_, O, precision)
    assert (plan.instance, plan.vec, plan.rows, plan.grid, plan.kchunk) == (
        instance, vec, rows, grid, kchunk)
    assert plan.block == K.W8_INSTANCES[instance][2]
    assert plan.split == grid[2]
    # the splits cover K once, each a multiple of the instance's k step and
    # at least the least k a split walks; the partials' scratch
    step = K.W8_GEMV_K if instance == "gemv" else K.W8_INSTANCES[instance][1][2]
    least = K.W8_GEMV_SPLIT_MIN_K if instance == "gemv" else K.W8_SPLIT_MIN_K
    if plan.split > 1:
        assert plan.kchunk % step == 0 and plan.kchunk >= least
        assert (plan.split - 1) * plan.kchunk < K_ <= plan.split * plan.kchunk
        assert plan.scratch_floats == plan.split * B * O
    else:
        assert plan.scratch_floats == 0 and plan.kchunk >= K_


def test_w8_plan_refuses_what_the_kernel_refuses():
    """Only a K whose padded row of f32 does not fit one block's shared
    memory (int8_tile_rows' refusal, naming the width), and an unknown
    precision."""
    assert K.w8_plan(4, 58112, 10).instance == "gemv"  # the widest that runs
    with pytest.raises(ValueError, match="58128"):
        K.w8_plan(4, 58113, 10)
    with pytest.raises(ValueError, match="58128"):
        K.int8_tile_rows(4, 58128, 4)
    with pytest.raises(ValueError, match="precision"):
        K.w8_plan(4, 64, 10, "fast")


# w8a8_plan per shape: (B, K, O) -> (instance, rows, tiles, grid, kchunk).
# The flagship's layers at the --int8 buckets (and B = 1), the 4096-wide
# layer at B = 16 and 64, a ragged K; K split over a cluster where it is long
# and the blocks few (4096 -> 64) or where a block's codes would not fit its
# shared memory (4096 at B = 64); the one launch at B <= 8 and K <= 1024
# (the flagship at bucket 8, the bound at 1024 and 1025).
W8A8_PLANS = [
    (1, 784, 300, "fused", 8, 1, (1, 19, 1), 832),
    (1, 300, 100, "fused", 8, 1, (1, 7, 1), 320),
    (1, 100, 10, "fused", 8, 1, (1, 1, 1), 128),
    (8, 784, 300, "fused", 8, 1, (1, 19, 1), 832),
    (8, 300, 100, "fused", 8, 1, (1, 7, 1), 320),
    (8, 100, 10, "fused", 8, 1, (1, 1, 1), 128),
    (64, 784, 300, "pdl", 64, 1, (1, 19, 1), 832),
    (64, 300, 100, "pdl", 64, 1, (1, 7, 1), 320),
    (64, 100, 10, "pdl", 64, 1, (1, 1, 1), 128),
    (512, 784, 300, "pdl", 64, 2, (1, 10, 8), 832),
    (512, 300, 100, "pdl", 64, 1, (1, 7, 8), 320),
    (512, 100, 10, "pdl", 64, 1, (1, 1, 8), 128),
    (16, 4096, 4096, "pdl", 16, 2, (1, 128, 1), 4096),
    (64, 4096, 4096, "pdl", 64, 4, (2, 64, 1), 2048),
    (40, 257, 130, "pdl", 64, 1, (1, 9, 1), 320),
    (5, 257, 130, "fused", 8, 1, (1, 9, 1), 320),
    (5, 12, 9, "fused", 8, 1, (1, 1, 1), 64),
    (8, 1024, 300, "fused", 8, 1, (1, 19, 1), 1024),
    (8, 1025, 300, "pdl", 8, 1, (2, 19, 1), 576),
    (9, 100, 10, "pdl", 16, 1, (1, 1, 1), 128),
    (37, 4096, 64, "pdl", 64, 1, (8, 4, 1), 512),
    (8, 4096, 64, "pdl", 8, 1, (8, 4, 1), 512),
]


@pytest.mark.parametrize("B,K_,O,instance,rows,tiles,grid,kchunk", W8A8_PLANS)
def test_w8a8_plan_per_shape(B, K_, O, instance, rows, tiles, grid, kchunk):
    plan = K.w8a8_plan(B, K_, O)
    assert (plan.instance, plan.rows, plan.tiles, plan.grid, plan.kchunk) == (
        instance, rows, tiles, grid, kchunk)
    split, gx, gy = plan.grid
    # the split's blocks cover K once, each a whole number of 64-k chunks;
    # the tiles cover O and the row tiles B; the smem and scratch counts
    assert plan.split == split <= K.W8A8_MAX_SPLIT
    assert plan.kchunk % K.W8A8_CHUNK == 0
    assert (split - 1) * plan.kchunk < K_ <= split * plan.kchunk
    assert gx * tiles * K.W8A8_TILE_COLS >= O and gy * rows >= B
    assert plan.smem_bytes == K.w8a8_smem_bytes(instance, rows, tiles, kchunk)
    assert plan.smem_bytes <= K.MAX_SMEM_BYTES
    assert plan.scratch_bytes == (B * K.padded_width(K_) + 4 * B
                                  if instance == "pdl" else 0)
    assert instance == "pdl" or split == 1


def test_w8a8_plan_forced_instance():
    """The timing's forced instance is kept; the one launch never splits,
    holds no scratch and takes at most 8 rows; the pair's scratch is its
    codes and scales."""
    p = K.w8a8_plan(8, 784, 300, instance="pdl")
    assert (p.instance, p.split, p.grid, p.scratch_bytes) == (
        "pdl", 1, (1, 19, 1), 8 * 784 + 32)
    p = K.w8a8_plan(8, 4096, 64, instance="fused")
    assert (p.instance, p.split, p.rows, p.scratch_bytes) == (
        "fused", 1, 8, 0)  # never a split
    with pytest.raises(ValueError, match="at most 8 rows"):
        K.w8a8_plan(9, 100, 10, instance="fused")
    p = K.w8a8_plan(8, 100, 10, instance="pdl")
    assert p.instance == "pdl" and p.scratch_bytes == 8 * 112 + 32


def test_w8a8_plan_refuses_what_the_kernel_refuses():
    """A K whose slice does not fit a block's shared memory even at 8 rows
    and the largest split (naming the width), an unknown instance; an
    unknown act is refused by the wrapper before any plan."""
    for B in (1, 512):
        assert K.w8a8_plan(B, 230912, 10)[4:6] == (K.W8A8_MAX_SPLIT, 28864)
        with pytest.raises(ValueError, match="input width of 230913"):
            K.w8a8_plan(B, 230913, 10)
    with pytest.raises(ValueError, match="instance"):
        K.w8a8_plan(8, 64, 10, instance="dp4a")
    x, _, b, q, s = jax_quantized_layer(51, 4, 6, 20)
    with pytest.raises(ValueError, match="activation"):
        K.fused_linear_w8a8(t(x), t(q), t(s), t(b), "softplus")


@pytest.mark.parametrize("B,N,L,rows,groups,grid,tiles,kc,depth", [
    (16, 4096, 4, 16, 1, 128, 1, 1024, 4),   # the serving stack, bucket 16
    (5, 4096, 4, 5, 1, 128, 1, 1024, 4),
    (64, 4096, 4, 64, 1, 128, 1, 1024, 2),   # four m16 tiles in one group
    (100, 4096, 4, 50, 2, 128, 1, 1024, 2),  # two groups of 50 rows
    (37, 512, 3, 37, 1, 16, 1, 512, 5),
    (16, 256, 1, 16, 1, 8, 1, 256, 8),
    (16, 8192, 1, 16, 1, 132, 2, 1024, 4),   # two column tiles a block
    (1, 232448, 2, 1, 1, 132, 56, 1024, 4),  # the widest row that runs
])
def test_mlp_w8a8_plan_per_shape(B, N, L, rows, groups, grid, tiles, kc,
                                 depth):
    plan = K.mlp_w8a8_plan(B, N, L)
    assert (plan.rows, plan.groups, plan.grid, plan.tiles, plan.kc,
            plan.depth) == (rows, groups, grid, tiles, kc, depth)
    assert plan.smem_bytes == K.mlp_w8a8_smem_bytes(rows, kc, depth, tiles)
    assert plan.smem_bytes <= K.MAX_SMEM_BYTES
    # no deeper ring fits, the groups cover B, the blocks' tiles cover N
    assert (depth == K.MLP8_MAX_STAGES or K.mlp_w8a8_smem_bytes(
        rows, kc, depth + 1, tiles) > K.MAX_SMEM_BYTES)
    assert rows * groups >= B > rows * (groups - 1)
    assert rows <= K.MLP8_MAX_ROWS and grid <= K.H100_SMS
    assert grid * tiles * K.MLP8_COLS >= N > grid * (tiles - 1) * K.MLP8_COLS


@pytest.mark.parametrize("B", [1, 16, 65, 512])
def test_mlp_w8a8_plan_runs_every_width_that_runs_today(B):
    """Every N that int8_tile_rows takes gets a plan that fits; the first N
    past it is refused naming the width, as int8_tile_rows refuses it."""
    for N in (128, 4096, 65536, 232448):
        assert K.int8_tile_rows(B, N, 1) >= 1
        plan = K.mlp_w8a8_plan(B, N, 3)
        assert plan.smem_bytes <= K.MAX_SMEM_BYTES
        assert plan.depth >= 2 and plan.rows * plan.groups >= B
    with pytest.raises(ValueError, match="232576"):
        K.int8_tile_rows(B, 232576, 1)
    with pytest.raises(ValueError, match="232576"):
        K.mlp_w8a8_plan(B, 232576, 3)


def test_cpu_int8_path_launches_no_kernel():
    K.reset_launch_counts()
    x, _, b, q, s = jax_quantized_layer(60, 3, 5, 16)
    K.fused_linear_w8(t(x), t(q), t(s), t(b))
    K.fused_linear_w8a8(t(x), t(q), t(s), t(b))
    xs, wq3, sw2, b2 = uniform_stack(61, L=2, B=2)
    K.fused_mlp_w8a8_forward(t(xs), t(wq3), t(sw2), t(b2))
    assert set(K.launch_counts().values()) == {0}
