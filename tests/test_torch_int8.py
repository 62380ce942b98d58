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


def test_cpu_int8_path_launches_no_kernel():
    K.reset_launch_counts()
    x, _, b, q, s = jax_quantized_layer(60, 3, 5, 16)
    K.fused_linear_w8(t(x), t(q), t(s), t(b))
    K.fused_linear_w8a8(t(x), t(q), t(s), t(b))
    xs, wq3, sw2, b2 = uniform_stack(61, L=2, B=2)
    K.fused_mlp_w8a8_forward(t(xs), t(wq3), t(sw2), t(b2))
    assert set(K.launch_counts().values()) == {0}
