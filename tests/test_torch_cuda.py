"""The CUDA kernels against their plain versions on the card, at edge
shapes the smoke run does not reach: ragged corpus and row counts,
several query blocks, k up to 128 and the scores-only mode above it,
planted ties, fully masked corpora and row ranges, head dim 32, hidden
384.  Marked ``cuda``; skipped where there is no card.  On a machine with
one (``--noconftest``: ``tests/conftest.py`` imports jax, which the port's
machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are those of ``chip_smoke.py``: bf16/f32 top-k scores 1e-4
with ids equal outside near-ties; the int8 and int4 scans exactly equal
(exact int32 dots, the same FMA, first-index ties); attention 3e-2 (a
bf16 ulp or two of O(1) outputs); the int8 FFN 6.25e-2 at most (a few
bf16 ulps of the LayerNorm output), 1e-4 on average and at most 1 % of
outputs more than one bf16 ulp off, on random inputs and on the planted
ones of ``chip_smoke.planted_ffn_inputs``, at H 8 to 1,024; the int8 GEMM
family (``int8_gemm``, ``int8_ffn_in``, ``int8_ffn_out``,
``int8_ffn_fused``) within ``chip_smoke.int8_ok`` (one ulp of the output
dtype at most, 0.01 on average, 0.1 % over one ulp) on random inputs, zero
rows, ragged M and K/N off the 128 grid, and on the planted inputs of
``chip_smoke.planted_rows``; ``int8_ffn_ln`` equal to its plain version on
``chip_smoke.planted_epilogue``'s inputs; the stock-flash kernel within the
attention tolerances at S 128 to 512 and head sizes 8 to 128, with padded
rows; the int4 probe's variants equal to their plain versions and the
scan-overhead probe's within the flat scan's 1e-4.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,q,k", [(1000, 1, 10), (4133, 40, 128),
                                   (300, 17, 100)])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_flat_topk_kernel(dev, dtype, n, q, k, metric):
    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.topk_scan import (
        flat_topk_plain,
        row_penalty,
        row_sq_norms,
    )

    gen = torch.Generator(device=dev).manual_seed(n + q)
    v = torch.randn((n, 96), generator=gen, device=dev).to(dtype)
    v[7] = v[3]  # an exact tie: the lower id must come first
    mask = torch.rand((n,), generator=gen, device=dev) < 0.7
    mask[3] = mask[7] = True
    queries = torch.randn((q, 96), generator=gen, device=dev)
    queries[0] = v[3].float()
    pen, alpha = row_penalty(mask, metric, row_sq_norms(v))
    ks, ki = flat_topk_scan(v, pen, queries, k, alpha)
    ps, pi = flat_topk_plain(v, pen, queries, k, alpha)
    torch.cuda.synchronize()
    assert torch.allclose(ks, ps, atol=1e-4, rtol=1e-5, equal_nan=True)
    assert bool(((ki == pi) | ((ks - ps).abs() <= 1e-4)).all())
    if metric == "ip":
        assert ki[0, :2].tolist() == [3, 7]


def test_flat_topk_all_masked(dev):
    from tpu_search_torch.ops.flat_topk import flat_topk_scan

    v = torch.randn((500, 64), device=dev).to(torch.bfloat16)
    pen = torch.full((500,), float("inf"), device=dev)
    pen[[11, 499]] = 0.0
    s, i = flat_topk_scan(v, pen, torch.randn((3, 64), device=dev), 5)
    assert torch.isfinite(s[:, :2]).all() and torch.isneginf(s[:, 2:]).all()
    assert sorted(i[0, :2].tolist()) == [11, 499]
    assert (i[:, 2:] == -1).all()


@pytest.mark.parametrize("s,h,nh", [(64, 128, 4), (128, 768, 12),
                                    (512, 256, 4)])
def test_attention_kernel(dev, s, h, nh):
    from chip_smoke import attention_ok, bf16_errors
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention,
        mpnet_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(s)
    b = 5
    q, k, v = (torch.randn((b, s, h), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.randn((nh, s, s), generator=gen, device=dev)
    mask = torch.zeros((b, s), device=dev)
    mask[1, s // 3:] = float("-inf")
    mask[2] = torch.finfo(torch.float32).min
    scale = 1.0 / math.sqrt(h // nh)
    out = mpnet_attention(q, k, v, bias, mask, nh, scale)
    ref = mpnet_attention_plain(q, k, v, bias, mask, nh, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    errors = bf16_errors(out, ref)
    assert attention_ok(errors, "mpnet_attention"), errors


def ffn_args(dev, m, h, inter, seed):
    from tpu_search_torch.ops.int8_ffn import quantize_weight_columns

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=0.02):
        return scale * torch.randn(shape, generator=gen, device=dev)

    w1q, s1 = quantize_weight_columns(rnd(h, inter))
    w2q, s2 = quantize_weight_columns(rnd(inter, h))
    pre = rnd(m, h, scale=1.0).to(torch.bfloat16)
    pre[0] = 0.0
    return [pre, w1q.T.contiguous(), s1, rnd(inter), w2q.T.contiguous(), s2,
            rnd(h), 1 + rnd(h, scale=0.1), rnd(h, scale=0.1),
            1 + rnd(h, scale=0.1), rnd(h, scale=0.1)]


@pytest.mark.parametrize("m,h,inter", [(100, 768, 3072), (64, 384, 1536),
                                      (37, 312, 1200), (45, 1024, 4096),
                                      (20, 8, 8)])
def test_int8_ffn_kernel(dev, m, h, inter):
    from chip_smoke import bf16_errors, ffn_ok
    from tpu_search_torch.ops.int8_ffn import int8_ffn_ln, int8_ffn_ln_plain

    args = ffn_args(dev, m, h, inter, m)
    out = int8_ffn_ln(*args)
    ref = int8_ffn_ln_plain(*args)
    torch.cuda.synchronize()
    errors = bf16_errors(out, ref)
    assert ffn_ok(errors), errors


@pytest.mark.parametrize("kind", ["ties", "mul_div"])
@pytest.mark.parametrize("h,inter", [(768, 3072), (384, 1536), (312, 1200),
                                    (1024, 4096)])
def test_int8_ffn_kernel_planted_rounding(dev, kind, h, inter):
    """Inputs on which rounding half away from zero (``ties``) or dividing
    by ``amax / 127`` (``mul_div``) would move most int8 codes."""
    from chip_smoke import bf16_errors, ffn_ok, planted_ffn_inputs
    from tpu_search_torch.ops.int8_ffn import int8_ffn_ln, int8_ffn_ln_plain

    args = ffn_args(dev, 16, h, inter, 2)
    args[0], args[7], args[8] = planted_ffn_inputs(kind, h, 16, dev)
    out = int8_ffn_ln(*args, eps=0.0)
    ref = int8_ffn_ln_plain(*args, eps=0.0)
    torch.cuda.synchronize()
    errors = bf16_errors(out, ref)
    assert ffn_ok(errors), errors


@pytest.mark.parametrize("h,inter", [(1032, 4096), (768, 4104), (300, 1200),
                                    (312, 1204)])
def test_int8_ffn_refuses_widths(dev, h, inter):
    """Beyond H 1,024 / I 4,096, or off a multiple of 8, the wrapper raises
    with the limits in its message."""
    from tpu_search_torch.ops.int8_ffn import int8_ffn_ln

    args = ffn_args(dev, 8, h, inter, 1)
    with pytest.raises(ValueError, match="1024 / 4096"):
        int8_ffn_ln(*args)


def int8_operands(dev, m, k, n, seed):
    """Random int8 codes (row 0 of x_q all zero), f32 scales in [0.001,
    0.02] and biases: ``(x_q [m, k], w [n, k], sx, sw, bias)``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(n):
        return 0.001 + 0.019 * torch.rand((n,), generator=gen, device=dev)

    x_q = codes(m, k)
    x_q[0] = 0
    return (x_q, codes(n, k), scales(m), scales(n),
            0.1 * torch.randn((n,), generator=gen, device=dev))


INT8_SHAPES = [(37, 312, 1200), (128, 768, 3072), (200, 1024, 4096),
               (9, 8, 8), (300, 3072, 768)]


def assert_int8_close(got, ref):
    from chip_smoke import int8_ok, ulp_errors

    assert got.dtype == ref.dtype and got.shape == ref.shape
    errors = ulp_errors(got, ref)
    assert int8_ok(errors), errors


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_gemm_kernel(dev, m, k, n, gelu, out):
    from tpu_search_torch.ops.int8_gemm import int8_gemm, int8_gemm_plain

    ops = int8_operands(dev, m, k, n, m + k)
    got = int8_gemm(*ops, fuse_gelu=gelu, out_dtype=out)
    ref = int8_gemm_plain(*ops, fuse_gelu=gelu, out_dtype=out)
    torch.cuda.synchronize()
    assert_int8_close(got, ref)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_ffn_in_kernel(dev, m, k, n, out):
    from tpu_search_torch.ops.int8_gemm import int8_ffn_in, int8_ffn_in_plain

    ops = int8_operands(dev, m, k, n, m + n)
    h, amax = int8_ffn_in(*ops, out_dtype=out)
    ref_h, ref_amax = int8_ffn_in_plain(*ops, out_dtype=out)
    torch.cuda.synchronize()
    assert_int8_close(h, ref_h)
    assert amax.shape == (m, 1)
    assert_int8_close(amax, ref_amax)


def ffn_out_operands(dev, m, k, n, h_dtype, res_dtype, seed):
    """Gelu-like h (row 3 all zero: amax 0), its f32 row maxima, int8
    weights, scales, bias and a residual."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.nn.functional.gelu(
        2 * torch.randn((m, k), generator=gen, device=dev)).to(h_dtype)
    h[min(3, m - 1)] = 0
    _, w, _, sw, bias = int8_operands(dev, 1, k, n, seed)
    res = torch.randn((m, n), generator=gen, device=dev).to(res_dtype)
    return h, h.float().abs().amax(dim=1, keepdim=True), w, sw, bias, res


@pytest.mark.parametrize("h_dtype,res_dtype,out", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m,k,n", [(37, 1200, 312), (128, 3072, 768),
                                   (200, 4096, 1024), (9, 8, 8)])
def test_int8_ffn_out_kernel(dev, m, k, n, h_dtype, res_dtype, out):
    from tpu_search_torch.ops.int8_gemm import int8_ffn_out, int8_ffn_out_plain

    ops = ffn_out_operands(dev, m, k, n, h_dtype, res_dtype, m + k)
    got = int8_ffn_out(*ops, out_dtype=out)
    ref = int8_ffn_out_plain(*ops, out_dtype=out)
    torch.cuda.synchronize()
    assert_int8_close(got, ref)


@pytest.mark.parametrize("kind", ["ties", "mul_div"])
@pytest.mark.parametrize("k,n", [(3072, 768), (1200, 312)])
def test_int8_ffn_out_kernel_planted_rounding(dev, kind, k, n):
    """h on .5 steps (``ties``) and on the multiply-vs-divide discriminator
    (``mul_div``): a fault there moves most codes."""
    from chip_smoke import planted_rows
    from tpu_search_torch.ops.int8_gemm import int8_ffn_out, int8_ffn_out_plain

    h = planted_rows(kind, k, 64, dev)
    _, _, w, sw, bias, res = ffn_out_operands(dev, 64, k, n, torch.float32,
                                              torch.float32, 5)
    ops = (h, h.amax(dim=1, keepdim=True), w, sw, bias, res)
    got = int8_ffn_out(*ops, out_dtype=torch.float32)
    ref = int8_ffn_out_plain(*ops, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert_int8_close(got, ref)


def fused_operands(dev, m, h, inter, res_dtype, seed):
    x_q, w1, sx, s1, b1 = int8_operands(dev, m, h, inter, seed)
    _, w2, _, s2, b2 = int8_operands(dev, 1, inter, h, seed + 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = torch.randn((m, h), generator=gen, device=dev).to(res_dtype)
    # codes of 1/8 the range keep y in gelu's curved part
    return [(x_q // 8).contiguous(), sx, w1, s1, b1, w2, s2, b2, res]


@pytest.mark.parametrize("res_dtype,out", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("m,h,inter", [(37, 312, 1200), (100, 768, 3072),
                                       (45, 1024, 4096), (64, 384, 1536),
                                       (9, 8, 8)])
def test_int8_ffn_fused_kernel(dev, m, h, inter, res_dtype, out):
    from tpu_search_torch.ops.int8_gemm import (
        int8_ffn_fused,
        int8_ffn_fused_plain,
    )

    ops = fused_operands(dev, m, h, inter, res_dtype, m + h)
    got = int8_ffn_fused(*ops, out_dtype=out)
    ref = int8_ffn_fused_plain(*ops, out_dtype=out)
    torch.cuda.synchronize()
    assert_int8_close(got, ref)


@pytest.mark.parametrize("kind", ["ties", "mul_div"])
@pytest.mark.parametrize("h,inter", [(768, 3072), (312, 1200)])
def test_int8_ffn_fused_kernel_planted_rounding(dev, kind, h, inter):
    """An all-zero x_q makes y the GEMM1 bias, planted where gelu returns
    its input: the on-chip h_q lands on .5 steps or on the
    multiply-vs-divide discriminator."""
    from chip_smoke import planted_rows
    from tpu_search_torch.ops.int8_gemm import (
        int8_ffn_fused,
        int8_ffn_fused_plain,
    )

    ops = fused_operands(dev, 40, h, inter, torch.float32, 3)
    ops[0] = torch.zeros_like(ops[0])
    ops[4] = planted_rows(kind, inter, 1, dev)[0]
    got = int8_ffn_fused(*ops, out_dtype=torch.float32)
    ref = int8_ffn_fused_plain(*ops, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert_int8_close(got, ref)


def test_int8_family_refuses_shapes(dev):
    from tpu_search_torch.ops import int8_gemm as G

    x_q, w, sx, sw, bias = int8_operands(dev, 16, 64, 64, 1)
    with pytest.raises(ValueError, match="multiples of 8"):
        G.int8_gemm(x_q[:, :60].contiguous(), w[:, :60].contiguous(), sx, sw,
                    bias)
    with pytest.raises(ValueError, match="out_dtype"):
        G.int8_gemm(x_q, w, sx, sw, bias, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="w must be"):
        G.int8_ffn_in(x_q, w.T, sx, sw, bias)
    x_q, w1, sx, s1, b1 = int8_operands(dev, 16, 1032, 64, 2)
    _, w2, _, s2, b2 = int8_operands(dev, 1, 64, 1032, 3)
    res = torch.zeros((16, 1032), device=dev)
    with pytest.raises(ValueError, match="1024 / 4096"):
        G.int8_ffn_fused(x_q, sx, w1, s1, b1, w2, s2, b2, res)


def test_wrappers_raise_instead_of_falling_back(dev):
    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.mpnet_attention import mpnet_attention

    v = torch.randn((256, 64), device=dev)
    with pytest.raises(ValueError, match="k="):
        flat_topk_scan(v, torch.zeros(256, device=dev),
                       torch.randn((1, 64), device=dev), 257)
    x = torch.randn((1, 100, 128), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        mpnet_attention(x, x, x, torch.zeros((2, 100, 100), device=dev),
                        torch.zeros((1, 100), device=dev), 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [200, 1000])
def test_flat_topk_scores_mode(dev, dtype, k):
    """k > 128: the kernel writes the masked scores, a stable sort picks."""
    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.topk_scan import flat_topk_plain, row_penalty

    gen = torch.Generator(device=dev).manual_seed(k)
    v = torch.randn((3001, 96), generator=gen, device=dev).to(dtype)
    v[9] = v[2]
    mask = torch.rand((3001,), generator=gen, device=dev) < 0.8
    mask[2] = mask[9] = True
    queries = torch.randn((5, 96), generator=gen, device=dev)
    queries[0] = v[2].float()
    pen, alpha = row_penalty(mask, "ip")
    ks, ki = flat_topk_scan(v, pen, queries, k, alpha)
    ps, pi = flat_topk_plain(v, pen, queries, k, alpha)
    torch.cuda.synchronize()
    assert ks.shape == (5, k)
    assert torch.allclose(ks, ps, atol=1e-4, rtol=1e-5, equal_nan=True)
    assert bool(((ki == pi) | ((ks - ps).abs() <= 1e-4)).all())
    assert ki[0, :2].tolist() == [2, 9]


# (n, q, k, masked rows): odd N, several query blocks, a masked row range
# longer than a CTA's range (all-masked CTAs), every row masked.
QUANT_CASES = [
    (4133, 1, 1, None), (4133, 17, 10, None), (1000, 130, 128, None),
    (20000, 3, 10, (2000, 19000)), (300, 2, 5, (0, 300)),
    (4133, 9, 200, None), (777, 2, 777, (100, 700)),
]


def quant_inputs(dev, n, d, q, masked, seed):
    """Unit-norm rows with a planted duplicate, quantized by the port's
    quantizers; queries, the first one a corpus row; the 0 / -inf penalty
    with ~10 % of rows masked and ``masked`` (a row range) on top."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((n, d), generator=gen, device=dev)
    v = v / v.norm(dim=1, keepdim=True)
    v[min(7, n - 1)] = v[3]
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries[0] = v[3]
    live = torch.rand((n,), generator=gen, device=dev) >= 0.1
    live[3] = live[min(7, n - 1)] = True
    if masked is not None:
        live[masked[0]: masked[1]] = False
    pen = torch.where(live, 0.0, float("-inf"))
    return v, queries, pen


def assert_same_quant(got, want, pen):
    ks, ki = got
    ps, pi = want
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(torch.isfinite(ks), torch.isfinite(ps))
    assert torch.equal(ks[torch.isfinite(ks)], ps[torch.isfinite(ps)])
    assert bool(torch.isfinite(pen)[ki[ki >= 0].long()].all())


@pytest.mark.parametrize("words", [False, True])
@pytest.mark.parametrize("n,q,k,masked", QUANT_CASES)
def test_int8_kernel(dev, words, n, q, k, masked):
    from tpu_search_torch.index.flat import quantize_rows_int8
    from tpu_search_torch.ops.flat_topk_int8 import flat_topk_int8_scan
    from tpu_search_torch.ops.int8_pack import pack_int8_rows
    from tpu_search_torch.ops.topk_scan import flat_topk_int8_plain

    if words:
        n -= n % 4  # the word layout holds whole words
        k = min(k, n)
    v, queries, pen = quant_inputs(dev, n, 128, q, masked, n + q)
    rows, scales = quantize_rows_int8(v)
    corpus = pack_int8_rows(rows) if words else rows
    got = flat_topk_int8_scan(corpus, scales, pen, queries, k, words=words)
    want = flat_topk_int8_plain(rows, scales, pen, queries, k)
    assert_same_quant(got, want, pen)
    if masked is None and k > 1:
        assert got[1][0, :2].tolist() == [3, 7]


@pytest.mark.parametrize("n,q,k,masked", QUANT_CASES)
def test_int4_kernel(dev, n, q, k, masked):
    from tpu_search_torch.ops.flat_topk_int4 import flat_topk_int4_scan
    from tpu_search_torch.ops.int4_pack import (
        nibble_rows_to_bytes,
        quantize_rows_int4,
    )
    from tpu_search_torch.ops.topk_scan import flat_topk_int4_plain

    v, queries, pen = quant_inputs(dev, n, 128, q, masked, n + 2 * q)
    u, scales = quantize_rows_int4(v)
    nib = nibble_rows_to_bytes(u)
    got = flat_topk_int4_scan(nib, scales, pen, queries, k)
    want = flat_topk_int4_plain(nib, scales, pen, queries, k)
    assert_same_quant(got, want, pen)
    if masked is None and k > 1:
        assert got[1][0, :2].tolist() == [3, 7]


def test_quantizers_match_the_cpu(dev):
    """The row and query quantizers give the same bits on the card as on
    the CPU (where the tests hold them against the JAX package)."""
    from tpu_search_torch.index.flat import quantize_rows_int8
    from tpu_search_torch.ops.int4_pack import quantize_rows_int4
    from tpu_search_torch.ops.topk_scan import quantize_queries

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((4096, 768), generator=gen)
    for fn in (quantize_rows_int8, quantize_rows_int4, quantize_queries):
        for a, b in zip(fn(x), fn(x.to(dev))):
            assert torch.equal(a, b.cpu()), fn.__name__


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [8, 16])
def test_v1_scan_cases(dev, dtype, q):
    """``tests/test_pallas_topk.py::test_matches_xla_path`` on the CUDA
    scan: the same numpy inputs, an all-0 / +inf penalty.  The CPU tests
    hold the plain version against ``pallas_flat_topk`` on these inputs
    (``tests/test_torch_flat_topk.py``)."""
    from chip_smoke import v1_scan_inputs
    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.topk_scan import flat_topk_plain

    vecs, pen, queries, k = v1_scan_inputs("matches", dtype, q, dev)
    ks, ki = flat_topk_scan(vecs, pen, queries, k)
    ps, pi = flat_topk_plain(vecs, pen, queries, k)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.allclose(ks, ps, rtol=1e-5, atol=1e-5)


def test_v1_scan_all_masked_tile(dev):
    """``tests/test_pallas_topk.py::test_all_masked_tile_handled``."""
    from chip_smoke import v1_scan_inputs
    from tpu_search_torch.ops.flat_topk import flat_topk_scan

    vecs, pen, queries, k = v1_scan_inputs("masked_tile", "float32", 8, dev)
    _, ki = flat_topk_scan(vecs, pen, queries, k)
    assert bool((ki < 1024).all()) and bool((ki >= 0).all())


def test_quant_wrappers_raise_instead_of_falling_back(dev):
    from tpu_search_torch.ops.flat_topk_int4 import flat_topk_int4_scan
    from tpu_search_torch.ops.flat_topk_int8 import flat_topk_int8_scan

    rows = torch.zeros((256, 64), dtype=torch.int8, device=dev)
    nib = torch.zeros((128, 64), dtype=torch.uint8, device=dev)
    s = torch.ones(256, device=dev)
    pen = torch.zeros(256, device=dev)
    qs = torch.randn((2, 64), device=dev)
    with pytest.raises(TypeError):
        flat_topk_int8_scan(nib, s, pen, qs, 5)
    with pytest.raises(TypeError):
        flat_topk_int8_scan(rows, s, pen, qs, 5, words=True)
    with pytest.raises(TypeError):
        flat_topk_int4_scan(rows, s, pen, qs, 5)
    with pytest.raises(ValueError, match="cpu"):
        flat_topk_int8_scan(rows, s, pen.cpu(), qs, 5)
    with pytest.raises(ValueError, match="shape"):
        flat_topk_int8_scan(rows, s[:100], pen, qs, 5)
    with pytest.raises(ValueError, match="shape"):
        flat_topk_int4_scan(nib[:100], s, pen, qs, 5)
    with pytest.raises(ValueError, match="D % 16"):
        flat_topk_int8_scan(rows[:, :40].contiguous(), s, pen, qs[:, :40], 5)
    for k in (0, 257):
        with pytest.raises(ValueError, match="k="):
            flat_topk_int8_scan(rows, s, pen, qs, k)
        with pytest.raises(ValueError, match="k="):
            flat_topk_int4_scan(nib, s, pen, qs, k)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("k", [10, 200])
def test_index_search_runs_the_kernels(dev, dtype, k):
    """``FlatIndex.search`` on the card, k = 200 included, goes through its
    tier's kernel and agrees with the same index on the CPU."""
    import numpy as np

    from tpu_search_torch.index.flat import FlatIndex
    from tpu_search_torch.ops import _build

    rng = np.random.default_rng(k)
    data = rng.standard_normal((3000, 128)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = data[[5, 17, 2999]] + 0.01
    on_card, on_cpu = (FlatIndex(128, dtype=dtype, device=d)
                       for d in (dev, torch.device("cpu")))
    for index in (on_card, on_cpu):
        index.add(data)
        index.remove(range(0, 3000, 9))
    name = {"bfloat16": "flat_topk", "int8": "flat_topk_int8",
            "int4": "flat_topk_int4"}[dtype]
    before = _build.LAUNCHES[name]
    scores, ids = on_card.search(queries, k)
    assert _build.LAUNCHES[name] == before + 1
    want_s, want_i = on_cpu.search(queries, k)
    assert scores.shape == ids.shape == (3, k)
    if dtype == "bfloat16":
        np.testing.assert_allclose(scores, want_s, atol=1e-4, rtol=1e-5)
        assert ((ids == want_i) | (np.abs(scores - want_s) <= 1e-4)).all()
    else:
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_array_equal(scores, want_s)


def ivf_state(dev, nlist=9, cap=512, d=128, seed=3):
    """Ragged fills (one empty cluster), tombstones, a duplicated row (an
    exact tie), residual int8 / int4 codes of the rows."""
    from tpu_search_torch.index.flat import quantize_rows_int8
    from tpu_search_torch.ops.int4_pack import (
        nibble_rows_to_bytes,
        quantize_rows_int4,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    cent = torch.randn((nlist, d), generator=gen, device=dev)
    cent = cent / cent.norm(dim=1, keepdim=True)
    rows = cent[:, None] + 0.3 * torch.randn((nlist, cap, d), generator=gen,
                                             device=dev)
    rows[0, 9] = rows[0, 4]
    fills = torch.randint(10, cap + 1, (nlist,), generator=gen,
                          device=dev).int()
    fills[2] = 0
    valid = (torch.arange(cap, device=dev)[None] < fills[:, None]) & (
        torch.rand((nlist, cap), generator=gen, device=dev) > 0.2)
    valid[0, 4] = valid[0, 9] = True
    resid = (rows - cent[:, None]).reshape(-1, d)
    i8, s8 = quantize_rows_int8(resid)
    u, s4 = quantize_rows_int4(resid)
    return dict(cent=cent, rows=rows, fills=fills, valid=valid,
                i8=i8.reshape(nlist, cap, d), s8=s8.reshape(nlist, cap),
                nib=nibble_rows_to_bytes(u).reshape(nlist, cap // 2, d),
                s4=s4.reshape(nlist, cap))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q,nprobe,k", [(1, 3, 10), (20, 4, 128), (40, 9, 60),
                                        (3, 2, 300)])
def test_ivf_topk_kernel(dev, dtype, metric, q, nprobe, k):
    from tpu_search_torch.ops.ivf_scan import ivf_topk_plain, ivf_topk_scan

    st = ivf_state(dev)
    b = st["rows"].to(dtype)
    sq = (b.float() ** 2).sum(-1)
    pen = torch.where(st["valid"], sq if metric == "l2" else 0.0,
                      float("inf"))
    queries = torch.randn((q, 128), device=dev)
    queries[0] = b[0, 4].float()
    probe = torch.topk(queries @ st["cent"].T, nprobe).indices.int()
    alpha = 2.0 if metric == "l2" else 1.0
    ks, ki = ivf_topk_scan(b, pen, st["fills"], probe, queries, k, alpha)
    ps, pi = ivf_topk_plain(b, pen, st["fills"], probe, queries, k, alpha)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(ks), torch.isfinite(ps))
    fin = torch.isfinite(ps)
    assert float((ks[fin] - ps[fin]).abs().max()) <= 1e-4
    assert bool(((ki == pi) | ((ks - ps).abs() <= 1e-4)).all())
    if metric == "ip":
        assert ki[0, :2].tolist() == [4, 9]  # the tie: the lower slot first


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("q,nprobe,k", [(1, 3, 10), (8, 9, 128), (33, 4, 77),
                                        (2, 5, 250)])
def test_ivf_quant_kernels_exact(dev, kind, residual, q, nprobe, k):
    from tpu_search_torch.ops import ivf_scan

    st = ivf_state(dev, seed=q + nprobe)
    pen = torch.where(st["valid"], 0.0, float("-inf"))
    queries = torch.randn((q, 128), device=dev)
    cs = queries @ st["cent"].T
    probe = torch.topk(cs, nprobe).indices.int()
    cbias = torch.gather(cs, 1, probe.long()) if residual else None
    if kind == "int8":
        args = (st["i8"], st["s8"])
        kernel, plain = ivf_scan.ivf_topk_int8_scan, ivf_scan.ivf_topk_int8_plain
    else:
        args = (st["nib"], st["s4"])
        kernel, plain = ivf_scan.ivf_topk_int4_scan, ivf_scan.ivf_topk_int4_plain
    ks, ki = kernel(*args, pen, st["fills"], probe, queries, k, cbias)
    ps, pi = plain(*args, pen, st["fills"], probe, queries, k, cbias)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(ki, pi)


def test_ivf_all_masked_and_unprobed(dev):
    """Every probed row masked: -inf / -1 everywhere; a query whose only
    probe is the empty cluster: no candidates."""
    from tpu_search_torch.ops.ivf_scan import ivf_topk_int8_scan, ivf_topk_scan

    st = ivf_state(dev)
    pen = torch.full(st["valid"].shape, float("inf"), device=dev)
    probe = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32, device=dev)
    probe[1, 1] = 3
    s, i = ivf_topk_scan(st["rows"].to(torch.bfloat16), pen, st["fills"],
                         probe, torch.randn((2, 128), device=dev), 5)
    assert torch.isneginf(s).all() and (i == -1).all()
    probe = torch.tensor([[2]], dtype=torch.int32, device=dev)
    s, i = ivf_topk_int8_scan(st["i8"], st["s8"], torch.zeros_like(pen),
                              st["fills"], probe,
                              torch.randn((1, 128), device=dev), 5)
    assert torch.isneginf(s).all() and (i == -1).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_ivf_index_search_runs_the_kernels(dev, dtype):
    """``IVFIndex.search`` on the card goes through its dtype's kernel
    (int4 with a refine tier: also the flat int8 truth scan of its
    calibration) and agrees with the same index on the CPU."""
    import numpy as np

    from tpu_search_torch.index.ivf import IVFIndex
    from tpu_search_torch.ops import _build

    rng = np.random.default_rng(1)
    data = rng.standard_normal((4000, 128)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    on_card = IVFIndex(128, dtype=dtype, device=dev, nlist=16,
                       pq_auto=dtype == "int4")
    on_card.add(data)
    on_card.remove(range(0, 4000, 9))
    on_cpu = IVFIndex(128, dtype=dtype, device="cpu", nlist=16,
                      pq_auto=dtype == "int4")
    on_cpu.centroids = on_card.centroids
    on_cpu.add(data)
    on_cpu.remove(range(0, 4000, 9))
    name = {"bfloat16": "ivf_topk", "int8": "ivf_topk_int8",
            "int4": "ivf_topk_int4"}[dtype]
    before = _build.LAUNCHES[name]
    for k in (10, 200):
        scores, ids = on_card.search(data[[3, 77, 3999]], k, nprobe=4)
        want_s, want_i = on_cpu.search(data[[3, 77, 3999]], k, nprobe=4)
        np.testing.assert_allclose(scores, want_s, atol=1e-4, rtol=1e-5)
        assert ((ids == want_i) | (np.abs(scores - want_s) <= 1e-4)).all()
    assert _build.LAUNCHES[name] == before + 2
    if dtype == "int4":
        before = _build.LAUNCHES["flat_topk_int8"]
        report = on_card.calibrate_quant(target_recall=0.9)
        assert report["calibrated"]
        assert _build.LAUNCHES["flat_topk_int8"] == before + 1


@pytest.mark.parametrize("s,nh,hd", [(512, 12, 26), (512, 2, 32), (64, 4, 8),
                                     (128, 3, 120), (192, 2, 64)])
def test_attention_bhsd_kernel(dev, s, nh, hd):
    """The ``[B, heads, S, hd]`` kernel: padded head columns (hd 26, 8, 120)
    and the uint4 path (hd 32, 64); a padded row and a fully padded one;
    the gates of ``chip_smoke.attention_ok``."""
    from chip_smoke import attention_ok, bf16_errors
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention_bhsd,
        mpnet_attention_bhsd_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(s + hd)
    b = 5
    q, k, v = (torch.randn((b, nh, s, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.randn((nh, s, s), generator=gen, device=dev)
    mask = torch.zeros((b, s), device=dev)
    mask[1, s // 3:] = float("-inf")
    mask[2] = torch.finfo(torch.float32).min
    scale = 1.0 / math.sqrt(hd)
    before = _build.LAUNCHES["mpnet_attention_bhsd"]
    out = mpnet_attention_bhsd(q, k, v, bias, mask, scale)
    ref = mpnet_attention_bhsd_plain(q, k, v, bias, mask, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mpnet_attention_bhsd"] == before + 1
    assert torch.isfinite(out.float()).all()
    errors = bf16_errors(out, ref)
    assert attention_ok(errors, "mpnet_attention_bhsd"), errors


def test_attention_bhsd_wrapper_raises(dev):
    from tpu_search_torch.ops.mpnet_attention import mpnet_attention_bhsd

    x = torch.randn((1, 2, 100, 26), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        mpnet_attention_bhsd(x, x, x, torch.zeros((2, 100, 100), device=dev),
                             torch.zeros((1, 100), device=dev))
    x = torch.randn((1, 2, 64, 136), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        mpnet_attention_bhsd(x, x, x, torch.zeros((2, 64, 64), device=dev),
                             torch.zeros((1, 64), device=dev))


def test_cross_encoder_fixture_cuda_matches_cpu(dev):
    """The trained tiny-overlap reranker (H 64, hd 32: the bhsd kernel) on
    the card in bf16 against the CPU's f32 plain path: relevant above
    irrelevant on both, and the logits (the sigmoid saturates) within
    ``chip_smoke.RERANK_LOGIT_TOL`` of each other and in one order outside
    ties."""
    from pathlib import Path

    import numpy as np

    from chip_smoke import RERANK_LOGIT_TOL, classifier_reference, outranks_ok
    from tpu_search_torch.models.cross_encoder import (
        CrossEncoder,
        CrossEncoderConfig,
    )
    from tpu_search_torch.ops import _build

    fixtures = Path(__file__).resolve().parent / "fixtures"
    query = "alpha bravo charlie delta echo foxtrot"
    docs = ["alpha bravo charlie delta echo foxtrot",
            "delta echo foxtrot alpha kilo lima",
            "bravo charlie delta mike november",
            "apple banana cherry grape lemon mango",
            "kilo lima mike november oscar papa",
            "alphax bravox charliex deltax echox foxtrotx",
            "apple apple apple apple apple apple"]
    pairs = [(query, d) for d in docs]
    encoders = {}
    for device in ("cuda", "cpu"):
        encoder = CrossEncoder(CrossEncoderConfig(
            model_name="tiny-overlap", cache_dir=str(fixtures),
            device=device))
        before = _build.LAUNCHES["mpnet_attention_bhsd"]
        scores = encoder.predict(pairs)
        launched = _build.LAUNCHES["mpnet_attention_bhsd"] - before
        assert launched == (2 if device == "cuda" else 0)  # one per layer
        assert scores[:3].min() > scores[3:].max()
        encoders[device] = encoder
    card, cpu, cos = classifier_reference(encoders["cuda"], encoders["cpu"],
                                          pairs)
    assert cos > 0.999
    assert np.abs(card - cpu).max() <= RERANK_LOGIT_TOL, (card, cpu)
    assert outranks_ok(card, cpu, 2 * RERANK_LOGIT_TOL), (card, cpu)


@pytest.mark.parametrize("s,hd,nh", [(128, 64, 3), (256, 26, 2), (384, 32, 2),
                                     (512, 128, 2), (256, 8, 2)])
def test_flash_attention_kernel(dev, s, hd, nh):
    """The stock-flash kernel against its plain version: one block (S 128)
    and several, head sizes padded to 16 and not, a trained-scale bias, a
    padded tail, a mostly padded row and a fully padded one."""
    from chip_smoke import attention_ok, bf16_errors
    from tpu_search_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(s + hd)
    b = 4
    q, k, v = (torch.randn((b, nh, s, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ab = (2.0 * torch.randn((nh, s, s), generator=gen, device=dev)).to(
        torch.bfloat16)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    seg[1, s // 3:] = 0
    seg[2, 3:] = 0
    seg[3] = 0
    scale = 1.0 / math.sqrt(hd)
    out = flash_attention(q, k, v, ab, seg, seg, scale)
    ref = flash_attention_plain(q, k, v, ab, seg, seg, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    errors = bf16_errors(out, ref)
    assert attention_ok(errors, "flash_attention"), errors


@pytest.mark.parametrize("s,hd", [(64, 64), (192, 64), (256, 160)])
def test_flash_attention_refuses_shapes(dev, s, hd):
    from tpu_search_torch.ops.flash_attention import flash_attention

    q = torch.zeros((1, 2, s, hd), dtype=torch.bfloat16, device=dev)
    ab = torch.zeros((2, s, s), dtype=torch.bfloat16, device=dev)
    seg = torch.ones((1, s), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, ab, seg, seg, 1.0)


def test_int4_probe_variants(dev):
    """Every int4 probe variant equals its plain version (folds, top-k)."""
    from tpu_search_torch.benchmarks import int4_probe

    errors = int4_probe.check("cuda")
    assert set(errors.values()) == {0.0}, errors


def test_scan_overhead_probe_variants(dev):
    """Every scan-overhead variant agrees with its plain version."""
    from tpu_search_torch.benchmarks import scan_overhead_probe

    errors = scan_overhead_probe.check("cuda")
    assert max(errors.values()) <= scan_overhead_probe.SCORE_TOL, errors


@pytest.mark.parametrize("site", ["y", "ff"])
def test_int8_ffn_epilogue_rounds_once(dev, site):
    """On ``chip_smoke.planted_epilogue``'s inputs (exact LayerNorm
    statistics) the kernel equals its plain version bit for bit."""
    from chip_smoke import planted_epilogue
    from tpu_search_torch.ops.int8_ffn import int8_ffn_ln, int8_ffn_ln_plain

    ops, _ = planted_epilogue(site)
    t = [torch.from_numpy(x).to(dev) for x in (*ops[:7], *ops[7])]
    args = (t[0].to(torch.bfloat16), t[1].T.contiguous(), t[2], t[3],
            t[4].T.contiguous(), *t[5:])
    out = int8_ffn_ln(*args, eps=0.0)
    ref = int8_ffn_ln_plain(*args, eps=0.0)
    assert torch.equal(out, ref)
