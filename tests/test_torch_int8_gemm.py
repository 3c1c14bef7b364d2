"""The port's int8 GEMM family (``tpu_search_torch/ops/int8_gemm.py``, the
plain versions its wrappers take on the CPU) against the JAX package's
``ops/pallas_int8_gemm.py`` kernels in interpret mode, on the same numpy
inputs.

Tolerances (measured on these inputs):
- quantizer codes and scales: exactly equal to ``jax.jit(quantize_rows)``;
  the codes ``int8_ffn_out`` and ``int8_ffn_fused`` take on planted inputs:
  exactly equal to the JAX kernels';
- f32 outputs without gelu: equal (the int8 sums are exact on both sides
  and the epilogues round at the same sites);
- f32 outputs with gelu: within 4 f32 ulps of max(|ref|, max|ref| / 32).
  XLA's f32 tanh and PyTorch's differ by an ulp or two (read: up to 2
  ulps at that floor), and gelu's ``1 + tanh`` cancels for y < 0, so the
  error there scales with |y|, not with the output;
- bf16 outputs: within one bf16 ulp of max(|ref|, max|ref| / 4096).
The ragged case (M 37, K/N 312 and 1,200) runs the JAX kernels on inputs
zero-padded to their block multiples (as the JAX docstring tells callers
with ragged shapes to pad) and slices: padded codes add nothing, padded
columns carry zero scale and bias, padded rows are dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_search.ops import pallas_int8_gemm as G
from tpu_search_torch.models.convert import int8_operands_from_numpy
from tpu_search_torch.ops import int8_gemm as P

RAGGED = (37, 312, 1200)
SHAPES = [(16, 256, 128), (64, 512, 512), RAGGED]


def jdt(out):
    return jnp.float32 if out == "float32" else jnp.bfloat16


def tdt(out):
    return torch.float32 if out == "float32" else torch.bfloat16


def assert_ulps(got, ref, out, gelu=True):
    """``got`` (torch) within the stated tolerance of ``ref`` (numpy)."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if out == "float32" and not gelu:
        np.testing.assert_array_equal(got, ref)
        return
    bits, n_ulps, frac = (24, 4, 1 / 32) if out == "float32" else (8, 1, 1 / 4096)
    floor = np.maximum(np.abs(ref), np.abs(ref).max() * frac)
    ulp = np.ldexp(np.ones_like(ref), np.frexp(floor)[1] - bits)
    worst = float((np.abs(got - ref) / ulp).max())
    assert worst <= n_ulps, worst


def pad_to(a, shape):
    out = np.zeros(shape, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def up(v, to):
    return -(-v // to) * to


def operands(m, k, n, seed):
    """Random int8 codes (row 0 of x_q zero), scales in [0.001, 0.02] and
    biases, as ``tests/test_int8_gemm.py`` draws them."""
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    x_q[0] = 0
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sx = rng.uniform(0.001, 0.02, size=m).astype(np.float32)
    sw = rng.uniform(0.001, 0.02, size=n).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x_q, w, sx, sw, bias


def jax_gemm_family(fn, x_q, w, sx, sw, bias, **kw):
    """``fn`` (int8_gemm or int8_ffn_in) on inputs padded to 8 rows and
    128 columns, sliced back."""
    m, k = x_q.shape
    n = w.shape[1]
    mp, kp, np_ = up(m, 8), up(k, 128), up(n, 128)
    args = (pad_to(x_q, (mp, kp)), pad_to(w, (kp, np_)), pad_to(sx, (mp,)),
            pad_to(sw, (np_,)), pad_to(bias, (np_,)))
    res = fn(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    if isinstance(res, (tuple, list)):
        return [np.asarray(r.astype(jnp.float32))[:m, :n if i == 0 else 1]
                for i, r in enumerate(res)]
    return np.asarray(res.astype(jnp.float32))[:m, :n]


def port(x_q, w, sx, sw, bias):
    tw, tsw, tb = int8_operands_from_numpy(w, sw, bias, device="cpu")
    return torch.from_numpy(x_q), tw, torch.from_numpy(sx), tsw, tb


# -- quantize_rows ----------------------------------------------------------


def test_quantize_rows_bit_identical_to_jit():
    """20,000 bf16 rows of 0.5 N(0, 1), 768 wide, and an all-zero row: codes
    and scales equal the jitted JAX function's (the form ``jit`` callers
    get), which differs from its eager form on this input."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(0.5 * rng.standard_normal((20001, 768)),
                    jnp.float32).astype(jnp.bfloat16)
    x = x.at[20000].set(0)
    jq, js = jax.jit(G.quantize_rows)(x)
    eq, es = G.quantize_rows(x)
    assert (np.asarray(es) != np.asarray(js)).sum() > 100
    tq, ts = P.quantize_rows(torch.from_numpy(
        np.array(x.astype(jnp.float32))).to(torch.bfloat16))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[20000] == 1.0 and not tq[20000].any()


# -- int8_gemm, int8_ffn_in -------------------------------------------------


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_gemm_matches_jax(m, k, n, gelu, out):
    ops = operands(m, k, n, m + k)
    ref = jax_gemm_family(G.int8_gemm, *ops, fuse_gelu=gelu,
                          out_dtype=jdt(out))
    got = P.int8_gemm(*port(*ops), fuse_gelu=gelu, out_dtype=tdt(out))
    assert got.dtype == tdt(out)
    assert_ulps(got, ref, out, gelu)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ffn_in_matches_jax(m, k, n, out):
    ops = operands(m, k, n, m + n)
    ref_h, ref_amax = jax_gemm_family(G.int8_ffn_in, *ops, out_dtype=jdt(out))
    h, amax = P.int8_ffn_in(*port(*ops), out_dtype=tdt(out))
    assert h.dtype == tdt(out) and amax.shape == (m, 1)
    assert_ulps(h, ref_h, out)
    assert_ulps(amax, ref_amax, "float32")


def test_ffn_in_amax_comes_from_f32_y():
    """A zero x_q row makes y the bias, and a bias of 10.05 (where gelu
    returns its input) has a bf16 value that rounds up to 10.0625: the row
    max is the f32 10.05 in both packages, not the bf16 h's."""
    x_q, w, sx, sw, bias = operands(16, 128, 256, 3)
    x_q[5] = 0
    bias[17] = 10.05
    v = np.float32(10.05)
    assert float(torch.tensor(v).to(torch.bfloat16)) == 10.0625
    ref_h, ref_amax = jax_gemm_family(G.int8_ffn_in, x_q, w, sx, sw, bias)
    h, amax = P.int8_ffn_in(*port(x_q, w, sx, sw, bias))
    assert ref_amax[5, 0] == v and float(amax[5, 0]) == v
    assert float(h[5].float().abs().max()) == 10.0625 == ref_h[5].max()


# -- int8_ffn_out -------------------------------------------------------------


def ffn_out_operands(m, k, n, seed, h_dtype):
    rng = np.random.default_rng(seed)
    h = np.array(jnp.asarray(2.0 * rng.standard_normal((m, k)), jnp.float32)
                 .astype(h_dtype).astype(jnp.float32))
    h[5] = 0.0  # all-zero row: amax 0, codes 0, scale 1
    amax = np.abs(h).max(axis=1, keepdims=True).astype(np.float32)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sw = rng.uniform(0.001, 0.02, size=n).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return h, amax, w, sw, bias, res


def jax_ffn_out(h, amax, w, sw, bias, res, h_dtype, out):
    m, k = h.shape
    n = w.shape[1]
    mp, kp, np_ = up(m, 8), up(k, 128), up(n, 128)
    args = (jnp.asarray(pad_to(h, (mp, kp))).astype(h_dtype),
            pad_to(amax, (mp, 1)), pad_to(w, (kp, np_)), pad_to(sw, (np_,)),
            pad_to(bias, (np_,)), pad_to(res, (mp, np_)))
    ref = G.int8_ffn_out(*(jnp.asarray(a) for a in args), out_dtype=jdt(out),
                         interpret=True)
    return np.asarray(ref.astype(jnp.float32))[:m, :n]


def port_ffn_out(h, amax, w, sw, bias, res, h_dtype, out):
    tw, tsw, tb = int8_operands_from_numpy(w, sw, bias, device="cpu")
    th = torch.from_numpy(h).to(tdt("bfloat16" if h_dtype == jnp.bfloat16
                                    else "float32"))
    return P.int8_ffn_out(th, torch.from_numpy(amax), tw, tsw, tb,
                          torch.from_numpy(res), out_dtype=tdt(out))


@pytest.mark.parametrize("h_dtype,out", [(jnp.float32, "float32"),
                                         (jnp.bfloat16, "bfloat16"),
                                         (jnp.bfloat16, "float32")])
@pytest.mark.parametrize("m,k,n", [(16, 256, 128), (32, 512, 256),
                                   (37, 1200, 312)])
def test_ffn_out_matches_jax(m, k, n, h_dtype, out):
    ops = ffn_out_operands(m, k, n, m + k, h_dtype)
    ref = jax_ffn_out(*ops, h_dtype, out)
    got = port_ffn_out(*ops, h_dtype, out)
    assert got.dtype == tdt(out)
    assert_ulps(got, ref, out, gelu=False)


def codes_of(out, amax):
    """``out = h_q * scale`` (identity weights, unit scales, no bias or
    residual) -> the int8 codes ``h_q``."""
    scale = np.where(amax > 0, amax * np.float32(1 / 127), 1.0).astype(np.float32)
    return np.rint(np.asarray(out, np.float32) / scale).astype(np.int64)


@pytest.mark.parametrize("kind", ["ties", "mul_div"])
def test_ffn_out_codes_equal_jax(kind):
    """On .5-step ties and on the multiply-vs-divide discriminator (see
    ``chip_smoke.planted_rows``; half the rows negated) and an all-zero
    row, the requantized codes equal the JAX kernel's exactly, read back
    through identity weights."""
    k = 256
    h = chip_smoke.planted_rows(kind, k, 16, torch.device("cpu")).numpy()
    h[1::2] *= -1
    h[3] = 0.0
    amax = np.abs(h).max(axis=1, keepdims=True)
    eye = np.eye(k, dtype=np.int8)
    ones, zeros = np.ones(k, np.float32), np.zeros(k, np.float32)
    res = np.zeros((16, k), np.float32)
    ref = jax_ffn_out(h, amax, eye, ones, zeros, res, jnp.float32, "float32")
    got = port_ffn_out(h, amax, eye, ones, zeros, res, jnp.float32, "float32")
    want = np.clip(np.rint(h * (np.float32(127) / np.where(amax > 0, amax, 1))
                           .astype(np.float32)), -127, 127) * (amax > 0)
    np.testing.assert_array_equal(codes_of(ref, amax), want)
    np.testing.assert_array_equal(codes_of(got.numpy(), amax), want)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- int8_ffn_fused -------------------------------------------------------------


def fused_operands(m, hdim, idim, seed):
    """``tests/test_int8_ffn_kernels.py``'s fused inputs."""
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, size=(m, hdim)).astype(np.int8)
    x_q[7] = 0  # all-zero row: both scale guards must agree
    sx = rng.uniform(0.001, 0.02, size=m).astype(np.float32)
    w1 = rng.integers(-127, 128, size=(hdim, idim)).astype(np.int8)
    s1 = rng.uniform(0.001, 0.02, size=idim).astype(np.float32)
    b1 = (rng.standard_normal(idim) * 0.01).astype(np.float32)
    w2 = rng.integers(-127, 128, size=(idim, hdim)).astype(np.int8)
    s2 = rng.uniform(0.001, 0.02, size=hdim).astype(np.float32)
    b2 = (rng.standard_normal(hdim) * 0.01).astype(np.float32)
    res = rng.standard_normal((m, hdim)).astype(np.float32)
    return [x_q, sx, w1, s1, b1, w2, s2, b2, res]


def jax_fused(ops, out):
    x_q, sx, w1, s1, b1, w2, s2, b2, res = ops
    m, hdim = x_q.shape
    idim = w1.shape[1]
    mp, hp, ip = up(m, 8), up(hdim, 128), up(idim, 128)
    args = (pad_to(x_q, (mp, hp)), pad_to(sx, (mp,)), pad_to(w1, (hp, ip)),
            pad_to(s1, (ip,)), pad_to(b1, (ip,)), pad_to(w2, (ip, hp)),
            pad_to(s2, (hp,)), pad_to(b2, (hp,)), pad_to(res, (mp, hp)))
    ref = G.int8_ffn_fused(*(jnp.asarray(a) for a in args), out_dtype=jdt(out),
                           interpret=True)
    return np.asarray(ref.astype(jnp.float32))[:m, :hdim]


def port_fused(ops, out, splits=1):
    x_q, sx, w1, s1, b1, w2, s2, b2, res = ops
    tw1, ts1, tb1 = int8_operands_from_numpy(w1, s1, b1, device="cpu")
    tw2, ts2, tb2 = int8_operands_from_numpy(w2, s2, b2, device="cpu")
    return P.int8_ffn_fused(torch.from_numpy(x_q), torch.from_numpy(sx), tw1,
                            ts1, tb1, tw2, ts2, tb2, torch.from_numpy(res),
                            out_dtype=tdt(out), splits=splits)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,hdim,idim", [(32, 128, 512), RAGGED])
def test_ffn_fused_matches_jax(m, hdim, idim, out):
    ops = fused_operands(m, hdim, idim, 3)
    got = port_fused(ops, out)
    assert got.dtype == tdt(out)
    assert_ulps(got, jax_fused(ops, out), out)


@pytest.mark.parametrize("kind", ["ties", "mul_div"])
def test_ffn_fused_codes_equal_jax(kind):
    """An all-zero x_q makes y the GEMM1 bias, planted where gelu returns
    its input: the codes of the on-chip h equal the JAX kernel's, read
    back through identity W2."""
    d = 256
    ops = fused_operands(16, d, d, 4)
    ops[0][:] = 0
    ops[4] = chip_smoke.planted_rows(kind, d, 1, torch.device("cpu"))[0].numpy()
    ops[5] = np.eye(d, dtype=np.int8)
    ops[6], ops[7] = np.ones(d, np.float32), np.zeros(d, np.float32)
    ops[8] = np.zeros((16, d), np.float32)
    ref, got = jax_fused(ops, "float32"), port_fused(ops, "float32").numpy()
    amax = np.full((16, 1), ops[4].max(), np.float32)
    want = np.rint(ops[4] * (np.float32(127) / ops[4].max()))
    np.testing.assert_array_equal(codes_of(ref, amax), np.tile(want, (16, 1)))
    np.testing.assert_array_equal(got, ref)


def test_pair_matches_fused():
    """At f32 the pair (``int8_ffn_in`` + ``int8_ffn_out``) and the fused
    FFN take the same quantization decisions and the same roundings: equal
    (the JAX test allows 1e-5 for its kernels' f32 association)."""
    ops = fused_operands(32, 128, 512, 3)
    x_q, sx, w1, s1, b1, w2, s2, b2, res = (torch.from_numpy(a) for a in ops)
    tw1, ts1, tb1 = int8_operands_from_numpy(ops[2], ops[3], ops[4], "cpu")
    tw2, ts2, tb2 = int8_operands_from_numpy(ops[5], ops[6], ops[7], "cpu")
    h, amax = P.int8_ffn_in(x_q, tw1, sx, ts1, tb1, out_dtype=torch.float32)
    pair = P.int8_ffn_out(h, amax, tw2, ts2, tb2, res, out_dtype=torch.float32)
    fused = port_fused(ops, "float32")
    assert torch.equal(pair, fused)
    np.testing.assert_allclose(pair.numpy(), jax_fused(ops, "float32"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("splits", [2, 3, 4, 64])
def test_splits_change_nothing(splits):
    ops = fused_operands(32, 128, 512, 5)
    assert torch.equal(port_fused(ops, "float32", splits),
                       port_fused(ops, "float32"))


# -- compositions -------------------------------------------------------------


def test_quantized_linear_accuracy():
    """``tests/test_int8_gemm.py``'s composition: per-row x per-channel
    W8A8 ~ the f32 GEMM to < 1 % (the per-channel weight quantizer is
    ``quantize_rows`` of the port's [out, in] layout itself)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.01).astype(np.float32)
    x_q, sx = P.quantize_rows(torch.from_numpy(x))
    w_q, sw = P.quantize_rows(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = P.int8_gemm(x_q, w_q, sx, sw, torch.from_numpy(bias),
                      out_dtype=torch.float32).numpy()
    want = x @ w + bias
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.01


def test_ffn_composition_accuracy():
    """``int8_gemm`` (gelu) + ``quantize_rows`` + ``int8_gemm`` ~ the f32
    FFN, and the pair ~ the same, to ~1 % (``tests/test_int8_ffn_kernels
    .py``'s end-to-end bound)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    w1 = (rng.standard_normal((128, 512)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((512, 128)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(512) * 0.01).astype(np.float32)
    b2 = (rng.standard_normal(128) * 0.01).astype(np.float32)
    t = torch.from_numpy
    x_q, sx = P.quantize_rows(t(x))
    w1_q, s1 = P.quantize_rows(t(np.ascontiguousarray(w1.T)))
    w2_q, s2 = P.quantize_rows(t(np.ascontiguousarray(w2.T)))
    h = P.int8_gemm(x_q, w1_q, sx, s1, t(b1), fuse_gelu=True,
                    out_dtype=torch.float32)
    h_q, sh = P.quantize_rows(h)
    got = P.int8_gemm(h_q, w2_q, sh, s2, t(b2), out_dtype=torch.float32)
    got = got.numpy() + x
    h2, amax = P.int8_ffn_in(x_q, w1_q, sx, s1, t(b1), out_dtype=torch.float32)
    pair = P.int8_ffn_out(h2, amax, w2_q, s2, t(b2), t(x),
                          out_dtype=torch.float32).numpy()
    c = 0.7978845608028654
    y = x @ w1 + b1
    want = (0.5 * y * (1 + np.tanh(c * (y + 0.044715 * y ** 3)))) @ w2 + b2 + x
    for out in (got, pair):
        assert np.linalg.norm(out - want) / np.linalg.norm(want) < 0.015


# -- the wrappers ------------------------------------------------------------


def test_wrappers_refuse_other_dtypes_and_devices():
    ops = port(*operands(8, 64, 64, 1))
    with pytest.raises(ValueError, match="out_dtype"):
        P.int8_gemm(*ops, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="splits"):
        port_fused(fused_operands(8, 64, 64, 1), "float32", splits=0)
    meta = [t.to("meta") for t in ops]
    with pytest.raises(ValueError, match="unsupported device"):
        P.int8_ffn_in(*meta)


def test_plain_is_the_cpu_path():
    ops = port(*operands(16, 128, 256, 2))
    assert torch.equal(P.int8_gemm(*ops, fuse_gelu=True),
                       P.int8_gemm_plain(*ops, fuse_gelu=True))
    for a, b in zip(P.int8_ffn_in(*ops), P.int8_ffn_in_plain(*ops)):
        assert torch.equal(a, b)
