"""The port's W8A8 post-attention half (plain version) against the JAX
package's ``int8_ffn_ln_fused`` in interpret mode.

Tolerance: f32 output within 1e-4 (LayerNorm sums in another order; the
int8 products are exact on both sides); bf16 output within 1e-2, about
one bf16 ulp of the O(1) LayerNorm output.  The quantization decisions
themselves are compared exactly on inputs built to land on .5, and the
per-column weight quantizer must be bit-identical to its jitted form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from tpu_search.ops.pallas_int8_gemm import int8_ffn_ln_fused
from tpu_search_torch.ops.int8_ffn import (
    _quantize_rows_mul,
    int8_ffn_ln,
    int8_ffn_ln_plain,
    quantize_weight_columns,
)

H, I = 128, 256


def jax_qcol(w):
    """The JAX per-column weight quantizer (models/mpnet.py, the
    ``_qcol_stacked`` body for one layer)."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0)
    s = jnp.where(amax > 0.0, amax / 127.0, 1.0)
    wq = jnp.clip(jnp.round(wf / s[None, :]), -127.0, 127.0).astype(jnp.int8)
    return wq, s


def weights(seed):
    rng = np.random.default_rng(seed)

    def bf(x):  # bf16-valued f32, as forward_hidden casts the layer
        return np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                        .astype(jnp.float32))

    w1 = bf(0.05 * rng.standard_normal((H, I)))
    w2 = bf(0.05 * rng.standard_normal((I, H)))
    w1[:, 3] = 0.0  # an all-zero column: scale 1, codes 0
    b1 = bf(0.05 * rng.standard_normal(I))
    b2 = bf(0.05 * rng.standard_normal(H))
    ln = [bf(1 + 0.1 * rng.standard_normal(H)), bf(0.1 * rng.standard_normal(H)),
          bf(1 + 0.1 * rng.standard_normal(H)), bf(0.1 * rng.standard_normal(H))]
    return w1, w2, b1, b2, ln


def run_both(pre, w1, w2, b1, b2, ln, eps, out):
    jq1, js1 = jax.jit(jax_qcol)(jnp.asarray(w1))
    jq2, js2 = jax.jit(jax_qcol)(jnp.asarray(w2))
    jdt = jnp.float32 if out == "float32" else jnp.bfloat16
    ref = int8_ffn_ln_fused(
        jnp.asarray(pre).astype(jdt), jq1, js1, jnp.asarray(b1), jq2, js2,
        jnp.asarray(b2), *(jnp.asarray(x) for x in ln),
        eps=eps, out_dtype=jdt, interpret=True,
    )
    tq1, ts1 = quantize_weight_columns(torch.from_numpy(w1))
    tq2, ts2 = quantize_weight_columns(torch.from_numpy(w2))
    tdt = torch.float32 if out == "float32" else torch.bfloat16
    got = int8_ffn_ln(
        torch.from_numpy(pre).to(tdt), tq1.T.contiguous(), ts1,
        torch.from_numpy(b1), tq2.T.contiguous(), ts2, torch.from_numpy(b2),
        *(torch.from_numpy(x) for x in ln), eps=eps, out_dtype=tdt,
    )
    assert got.dtype == tdt
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


def test_weight_quantizer_bit_identical():
    """Against ``jax.jit(jax_qcol)``, the form the jitted ``forward_hidden``
    runs (XLA computes ``amax / 127.0`` as ``amax * f32(1/127)``): the test
    weights, and all-mpnet-base-v2's ``[768, 3072]`` of bf16-valued
    0.02 N(0, 1), where the eager divide gives other scales and codes."""
    w1, w2, *_ = weights(0)
    rng = np.random.default_rng(11)
    big = np.array(jnp.asarray(0.02 * rng.standard_normal((768, 3072)),
                               jnp.float32).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    eager = np.asarray(jax_qcol(jnp.asarray(big))[1])
    assert (eager != np.asarray(jax.jit(jax_qcol)(jnp.asarray(big))[1])).sum() > 100
    for w in (w1, w2, big):
        jq, js = jax.jit(jax_qcol)(jnp.asarray(w))
        tq, ts = quantize_weight_columns(torch.from_numpy(w))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_plain_matches_pallas_fused(out):
    rng = np.random.default_rng(1)
    w1, w2, b1, b2, ln = weights(1)
    pre = rng.standard_normal((64, H)).astype(np.float32)
    pre[5] = 0.0  # an all-zero row: LN gives its bias, amax paths hit 0
    ln[1][:] = 0.0  # ... and a zero LN1 bias makes that row exactly zero
    got, ref = run_both(pre, w1, w2, b1, b2, ln, 1e-5, out)
    assert np.isfinite(got).all()
    tol = 1e-4 if out == "float32" else 1e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_plain_matches_pallas_fused_at_tinybert_width(out):
    """H 312, I 1,200 (TinyBERT-312), which the JAX kernel takes as whole
    rows and the CUDA kernel pads to 384 columns."""
    rng = np.random.default_rng(6)

    def bf(x):
        return np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                        .astype(jnp.float32))

    h, inter = 312, 1200
    w1 = bf(0.05 * rng.standard_normal((h, inter)))
    w2 = bf(0.05 * rng.standard_normal((inter, h)))
    b1, b2 = bf(0.05 * rng.standard_normal(inter)), bf(0.05 * rng.standard_normal(h))
    ln = [bf(1 + 0.1 * rng.standard_normal(h)), bf(0.1 * rng.standard_normal(h)),
          bf(1 + 0.1 * rng.standard_normal(h)), bf(0.1 * rng.standard_normal(h))]
    pre = rng.standard_normal((48, h)).astype(np.float32)
    got, ref = run_both(pre, w1, w2, b1, b2, ln, 1e-5, out)
    tol = 1e-4 if out == "float32" else 1e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_quantization_ties_round_half_to_even():
    """LN1 output lands exactly on k + 0.5 quantization steps: with
    rows of +-1 (mean 0, variance 1) and eps = 0 the LN output is the LN
    scale itself, chosen so that 127 / amax = 64 exactly."""
    w1, w2, b1, b2, ln = weights(2)
    steps = np.array([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 126.5, 127.0],
                     np.float32)
    scale = np.resize(steps, H) / 64.0
    ln[0] = scale.astype(np.float32)
    ln[1] = np.zeros(H, np.float32)
    pre = np.tile(np.where(np.arange(H) % 2 == 0, 1.0, -1.0), (16, 1))
    pre = pre.astype(np.float32)
    # x * (127 / amax) hits the half steps; rint rounds them to even
    x = torch.from_numpy((pre * scale).astype(np.float32))
    xq, _ = _quantize_rows_mul(x)
    want = np.rint(np.resize(steps * np.array([1, -1] * 4), H))
    np.testing.assert_array_equal(xq[0].numpy(), want)
    got, ref = run_both(pre, w1, w2, b1, b2, ln, 0.0, "float32")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_activation_scale_is_the_f32_quotient():
    """``127 / amax`` is the f32 quotient, as in the JAX kernel: with amax
    A = 1.1484375 and x = A / 2, ``x * (127 / A)`` is 63.5 and rounds to
    64, where ``127 * (1 / A)`` (PyTorch's ``127.0 / tensor``) or
    ``x / (A / 127)`` would give 63."""
    w1, w2, b1, b2, ln = weights(4)
    a = 1.1484375
    ln[0] = np.full(H, a / 2, np.float32)
    ln[0][0] = a
    ln[1] = np.zeros(H, np.float32)
    pre = np.tile(np.where(np.arange(H) % 2 == 0, 1.0, -1.0), (16, 1))
    pre = pre.astype(np.float32)
    xq, _ = _quantize_rows_mul(torch.from_numpy(pre * ln[0]))
    assert xq[0, 0] == 127 and bool((xq[:, 1:].abs() == 64).all())
    got, ref = run_both(pre, w1, w2, b1, b2, ln, 0.0, "float32")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_wrapper_refuses_non_cpu_non_cuda():
    t = torch.zeros((8, H), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        int8_ffn_ln(t, *([t] * 10))


def test_plain_is_the_cpu_path():
    rng = np.random.default_rng(3)
    w1, w2, b1, b2, ln = weights(3)
    pre = torch.from_numpy(rng.standard_normal((8, H)).astype(np.float32))
    q1, s1 = quantize_weight_columns(torch.from_numpy(w1))
    q2, s2 = quantize_weight_columns(torch.from_numpy(w2))
    args = (pre, q1.T.contiguous(), s1, torch.from_numpy(b1),
            q2.T.contiguous(), s2, torch.from_numpy(b2),
            *(torch.from_numpy(x) for x in ln))
    assert torch.equal(int8_ffn_ln(*args), int8_ffn_ln_plain(*args))


@pytest.mark.parametrize("site", ["y", "ff"])
def test_epilogue_rounds_once_as_the_jax_kernel(site):
    """The JAX kernel in interpret mode rounds both dequantize epilogues
    once (XLA contracts them into FMAs); the plain version must equal it
    bit for bit on inputs where rounding twice changes the bf16 output."""
    (pre, w1q, s1, b1, w2q, s2, b2, ln), (twice, once) = (
        chip_smoke.planted_epilogue(site))
    if site == "y":
        assert np.rint(twice) != np.rint(once)  # h_q 20 against 21
    else:
        # 1 + 40/128 against 1 + 41/128 in bf16
        assert (torch.tensor(twice).to(torch.bfloat16)
                != torch.tensor(once).to(torch.bfloat16))
    ref = int8_ffn_ln_fused(
        jnp.asarray(pre).astype(jnp.bfloat16), jnp.asarray(w1q),
        jnp.asarray(s1), jnp.asarray(b1), jnp.asarray(w2q), jnp.asarray(s2),
        jnp.asarray(b2), *(jnp.asarray(x) for x in ln), eps=0.0,
        out_dtype=jnp.bfloat16, interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    t = [torch.from_numpy(x) for x in (pre, w1q, s1, b1, w2q, s2, b2, *ln)]
    got = int8_ffn_ln(t[0].to(torch.bfloat16), t[1].T.contiguous(), t[2],
                      t[3], t[4].T.contiguous(), *t[5:], eps=0.0)
    np.testing.assert_array_equal(got.float().numpy(), ref)
