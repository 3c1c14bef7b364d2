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
attention tolerances at S 128 to 512 and head sizes 8 to 256, with padded
rows, its f32 forward (``flash_attention_f32.cu``) within 1e-5 with its
residuals, and its backward (``flash_attention_bwd.cu``) within
``chip_smoke.flash_bwd_ok`` of the plain version, bf16 and f32 (S to 1,024,
B 40), the same bits on a second call, and under autograd one launch of
each; both, in both dtypes, at head sizes above 256 (300 and 320 at S 128,
384 and 512 at S 256); the f32 backward's workspace at most an eighth of a
[B, heads, S, S] f32 scratch; head sizes the stock kernel refuses refused
with its error; the int4 probe's variants equal to their
plain versions and the scan-overhead probe's within the flat scan's 1e-4; the IVF int8 / int4
scans' prologue kernel equal to its plain twin on the cases of
``tests/ivf_prep_cases.py``, and both scans exact with the live schedule
empty, shorter than the grid and many times longer (nlist 4,099), and on
an exact tie at k = 128; the bf16 / f32 IVF scan's prologue equal to its
plain twin on the same cases, and the scan within 1e-4 at Q 1 to 128,
nprobe 8 and 32, k 10, 128 and 200 (both query blocks, both metrics); the
flat int4 and int8 scans' prologues equal to their plain twins, the int8
scan exact in both layouts at Q 1 to 130, and every flat digit scan at
most three launches a call at Q 1, 9 and 33 (torch.profiler: the most a
call over three windows after a warm-up, a window with no device event
left out); the flat bf16 / f32 ring scan within 1e-4 at Q 1 to 128, k 1
to 128 and its scores mode at 129 and 200, ip and l2, N off the tile grid
and a capacity with a +inf tail, a planted tie and every row masked, its
prologue equal to its plain twin and at most three launches a call.  The
``[B, S, H]`` attention also at S 512 with hd 32 and on a one-row query,
with rows padded by -inf and by the f32 min; ``int8_gemm`` and ``int8_ffn_in`` also at
M, N and K off their wgmma tiles (K 8 and 312); ``int8_ffn_out`` also at M
4,097, N 264 and K 8 and 312, its planted inputs run twice (for the
producer's proxy fence); ``int8_ffn_ln`` also at M 1, 127, 129 and 4,097
(the edges of its 128-row tiles) and with row maxima in I 1,200's partial
last column tile.  The fused query path's CUDA graphs (all-mpnet-base-v2's
widths at two layers): a replay equal to the eager run of the same window
at 1, 8, 9 and 32 queries, filtered or not; rows added and removed between
two replays of one graph seen, with no new capture; 8 threads dispatching
one graph at once, each collecting its own result.  The pq IVF search (plain
PyTorch on the card, no kernel of its own): a pq index saved on the CPU and
loaded on the card answers as on the CPU (scores within 1e-5, ids equal
outside ties), with and without OPQ, and its search captured in a CUDA
graph replays equal to the eager run.  The fused window over shards on
several cards (one graph on the encoder's card, one a card, one merge):
a replay equal to its eager run and to one card's answer, on two cards
(skipped below two) and with the same program on one card; under a
one-rank NCCL group, the gather a step between graph replays, the capture
and a replay each equal to the eager run and the window without the group,
with one gather a window.
"""

import math

import ivf_prep_cases
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


# (S, H, heads, B): S 512 at hd 32 (the MiniLM reranker's H 384), S 64 with
# B 1 (a query), and even B beside odd.
@pytest.mark.parametrize("s,h,nh,b", [(64, 128, 4, 5), (128, 768, 12, 5),
                                      (512, 256, 4, 5), (512, 384, 12, 4),
                                      (64, 768, 12, 1), (384, 768, 12, 6)])
def test_attention_kernel(dev, s, h, nh, b):
    from chip_smoke import attention_ok, bf16_errors
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention,
        mpnet_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(s + b)
    q, k, v = (torch.randn((b, s, h), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.randn((nh, s, s), generator=gen, device=dev)
    mask = torch.zeros((b, s), device=dev)
    if b == 1:
        mask[0, s // 2:] = float("-inf")  # a query's padded tail
    else:
        mask[1, s // 3:] = float("-inf")
        mask[2] = torch.finfo(torch.float32).min  # a padded row, finite
    if b > 3:
        mask[3] = float("-inf")  # a padded row whose max is not finite
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
                                      (20, 8, 8), (1, 768, 3072),
                                      (127, 384, 1536), (129, 312, 1200),
                                      (4097, 768, 3072)])
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


def test_int8_ffn_row_max_in_the_last_column_tile(dev):
    """At I 1,200 (nine 128-column tiles, the last one 48 wide) rows whose
    |h| maximum lies in the last, partial tile, so the requantize scale
    must collect that tile's maximum."""
    from chip_smoke import bf16_errors, ffn_ok
    from tpu_search_torch.ops.int8_ffn import int8_ffn_ln, int8_ffn_ln_plain

    args = ffn_args(dev, 200, 312, 1200, 7)
    args[3][1190] = 6.0  # gelu(6 + x w) is the row's largest |h|
    out = int8_ffn_ln(*args)
    ref = int8_ffn_ln_plain(*args)
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


# int8_gemm's wgmma tiles are 128 x 256 in 128-deep K chunks: M off the
# tile (129, 4,097), N off it (312), K off the chunk and off 16 bytes
# (312: the 8-byte copies) and K = 8.
INT8_GEMM_SHAPES = INT8_SHAPES + [(129, 768, 3072), (4097, 768, 312),
                                  (64, 312, 312), (130, 8, 264)]


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", INT8_GEMM_SHAPES)
def test_int8_gemm_kernel(dev, m, k, n, gelu, out):
    from tpu_search_torch.ops.int8_gemm import int8_gemm, int8_gemm_plain

    ops = int8_operands(dev, m, k, n, m + k)
    got = int8_gemm(*ops, fuse_gelu=gelu, out_dtype=out)
    ref = int8_gemm_plain(*ops, fuse_gelu=gelu, out_dtype=out)
    torch.cuda.synchronize()
    assert_int8_close(got, ref)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", INT8_GEMM_SHAPES)
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
# ffn_out_cq's tiles are 128 x 256 in 128-deep K chunks: N off the tile
# (312, 264), K off the 16-byte copies of w (8, 312), M off the row tile
# (37, 129, 4,097).
@pytest.mark.parametrize("m,k,n", [(37, 1200, 312), (128, 3072, 768),
                                   (200, 4096, 1024), (9, 8, 8),
                                   (4097, 3072, 768), (129, 312, 264)])
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
    (``mul_div``): a fault there moves most codes.  Run twice: a missing
    proxy fence between the producer's code stores and wgmma would read
    stale codes only now and then."""
    from chip_smoke import planted_rows
    from tpu_search_torch.ops.int8_gemm import int8_ffn_out, int8_ffn_out_plain

    h = planted_rows(kind, k, 64, dev)
    _, _, w, sw, bias, res = ffn_out_operands(dev, 64, k, n, torch.float32,
                                              torch.float32, 5)
    ops = (h, h.amax(dim=1, keepdim=True), w, sw, bias, res)
    ref = int8_ffn_out_plain(*ops, out_dtype=torch.float32)
    for _ in range(2):
        got = int8_ffn_out(*ops, out_dtype=torch.float32)
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
                                       (9, 8, 8), (129, 776, 1032)])
def test_int8_ffn_fused_kernel(dev, m, h, inter, res_dtype, out):
    """H and I off the 16-byte copies (8, 776, 1032: 8-byte copies in both
    products) and off the 128-row tile (129: a second, ragged row tile)."""
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


# (rows, live prefix): N off the 128-row grid, and a capacity whose slots
# past the live prefix carry +inf (the fused path's scan of the whole
# capacity, runs that end in all-masked tiles).
FLAT_SHAPES = [(4133, None), (2944, 1000)]


def flat_inputs(dev, n, live, q, dtype, metric, seed, d=96):
    """Rows with a planted exact tie (row 7 a copy of row 3, query 0 row
    3), about 30 % masked and ``live`` a live prefix; the penalty and
    alpha of ``metric``."""
    from tpu_search_torch.ops.topk_scan import row_penalty, row_sq_norms

    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    v[7] = v[3]
    mask = torch.rand((n,), generator=gen, device=dev) < 0.7
    mask[3] = mask[7] = True
    if live is not None:
        mask[live:] = False
    queries = torch.randn((q, d), generator=gen, device=dev)
    queries[0] = v[3].float()
    pen, alpha = row_penalty(mask, metric, row_sq_norms(v))
    return v, pen, queries, alpha


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 10, 128, 129, 200])
@pytest.mark.parametrize("q", [1, 8, 16, 17, 32, 40, 128])
def test_flat_topk_ring_kernel(dev, q, k, dtype):
    """The ring scan (both query blocks of bf16 rows, f32 rows) and its
    scores mode above k 128 against the plain version, on both shapes of
    ``FLAT_SHAPES`` (ip on one, l2 on the other, swapped with Q's
    parity): scores within 1e-4, ids equal outside ties of 1e-4, the
    planted tie lower id first, no masked row, -inf / -1 past the live
    rows."""
    from tpu_search_torch.ops.flat_topk import flat_topk_scan
    from tpu_search_torch.ops.topk_scan import flat_topk_plain

    metrics = ("ip", "l2") if q % 2 else ("l2", "ip")
    for (n, live), metric in zip(FLAT_SHAPES, metrics):
        v, pen, queries, alpha = flat_inputs(dev, n, live, q, dtype, metric,
                                             n + q + k)
        ks, ki = flat_topk_scan(v, pen, queries, k, alpha)
        ps, pi = flat_topk_plain(v, pen, queries, k, alpha)
        torch.cuda.synchronize()
        assert ks.shape == (q, k) and ki.shape == (q, k)
        assert torch.equal(torch.isfinite(ks), torch.isfinite(ps))
        assert torch.allclose(ks, ps, atol=1e-4, rtol=1e-5, equal_nan=True)
        assert bool(((ki == pi) | ((ks - ps).abs() <= 1e-4)).all())
        assert bool((ki[~torch.isfinite(ks)] == -1).all())
        assert bool(torch.isfinite(pen[ki[ki >= 0].long()]).all())
        assert ki[0, : min(k, 2)].tolist() == [3, 7][: min(k, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q,k", [(1, 10), (40, 128), (8, 200)])
def test_flat_topk_every_row_masked(dev, q, k, dtype):
    """A corpus with every row masked: -inf and id -1 in every slot."""
    from tpu_search_torch.ops.flat_topk import flat_topk_scan

    v = torch.randn((1000, 64), device=dev).to(dtype)
    pen = torch.full((1000,), float("inf"), device=dev)
    s, i = flat_topk_scan(v, pen, torch.randn((q, 64), device=dev), k)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(s).all()) and bool((i == -1).all())


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name", sorted(ivf_prep_cases.CASES))
def test_flat_float_prep_kernel_equals_plain(dev, name, bf16):
    """The flat bf16 / f32 scan's prologue kernel against its plain twin,
    bit for bit, on the queries of the IVF prologue cases."""
    from tpu_search_torch.ops.flat_topk import (
        flat_float_prep,
        flat_float_prep_plain,
    )

    queries = torch.from_numpy(ivf_prep_cases.make_case(name)[2])
    want = flat_float_prep_plain(queries, bf16)
    got = flat_float_prep(queries.to(dev), bf16)
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if value is None:
            assert got[key] is None
        else:
            assert torch.equal(got[key].cpu(), value), key


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q", [1, 9, 33])
def test_flat_topk_launches_three_kernels(dev, q, dtype):
    """The flat bf16 / f32 scan at k <= 128 is one C call of three
    launches: the prologue, the ring scan and the tree merge, no PyTorch
    op between them."""
    from tpu_search_torch.ops.flat_topk import flat_topk_scan

    v, pen, queries, alpha = flat_inputs(dev, 20000, 17000, q, dtype, "ip",
                                         q)
    per_call, names = launches_a_call(
        lambda: flat_topk_scan(v, pen, queries, 10, alpha))
    assert per_call <= 3
    for kernel in ("float_prep", "ivf_float_scan", "tree_merge"):
        assert any(kernel in name for name in names), kernel


# (n, q, k, masked rows): odd N, several query blocks, a masked row range
# longer than a CTA's range (all-masked CTAs), every row masked.
QUANT_CASES = [
    (4133, 1, 1, None), (4133, 17, 10, None), (1000, 130, 128, None),
    (20000, 3, 10, (2000, 19000)), (300, 2, 5, (0, 300)),
    (4133, 9, 200, None), (777, 2, 777, (100, 700)),
    (4133, 9, 128, None), (20000, 33, 128, (2000, 19000)),
    (4133, 33, 200, None),
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


def launches_a_call(fn, calls=4, windows=3):
    """Device events a call of ``fn`` (torch.profiler), the most over
    ``windows`` windows of ``calls`` calls after a warm-up, and the
    kernels' names.  A window in which the profiler recorded no device
    event (it happens now and then) is left out; at least one must record
    some."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts, names = [], set()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            counts.append(len(events) / calls)
            names |= {e.name for e in events}
    assert counts, "no profiler window recorded a device event"
    return max(counts), names


@pytest.mark.parametrize("layout", ["int8 rows", "int8 words", "int4"])
@pytest.mark.parametrize("q", [1, 9, 33])
def test_flat_digit_scans_launch_three_kernels(dev, layout, q):
    """A flat digit scan at k <= 128 is one C call of three launches:
    the prologue, the scan and the tree merge, no PyTorch op between."""
    from tpu_search_torch.index.flat import quantize_rows_int8
    from tpu_search_torch.ops.flat_topk_int4 import flat_topk_int4_scan
    from tpu_search_torch.ops.flat_topk_int8 import flat_topk_int8_scan
    from tpu_search_torch.ops.int4_pack import (
        nibble_rows_to_bytes,
        quantize_rows_int4,
    )
    from tpu_search_torch.ops.int8_pack import pack_int8_rows

    v, queries, pen = quant_inputs(dev, 20000, 128, q, None, q)
    words = layout == "int8 words"
    if layout == "int4":
        u, scales = quantize_rows_int4(v)
        corpus = nibble_rows_to_bytes(u)
    else:
        rows, scales = quantize_rows_int8(v)
        corpus = pack_int8_rows(rows) if words else rows

    def call():
        if layout == "int4":
            return flat_topk_int4_scan(corpus, scales, pen, queries, 10)
        return flat_topk_int8_scan(corpus, scales, pen, queries, 10,
                                   words=words)

    per_call, names = launches_a_call(call)
    assert per_call <= 3
    assert any("digit_prep" in name for name in names)
    assert any("tree_merge" in name for name in names)


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
    with pytest.raises(ValueError, match="D % 16"):
        flat_topk_int4_scan(nib[:, :40].contiguous(), s, pen, qs[:, :40], 5)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q", [1, 16, 17, 128])
@pytest.mark.parametrize("nprobe", [8, 32])
@pytest.mark.parametrize("k", [10, 128, 200])
def test_ivf_topk_kernel_probes(dev, dtype, metric, q, nprobe, k):
    """nlist 48: Q on both sides of the small-query cutoff (16), every
    query probing 8 or 32 lists, k in the selecting and the scores-only
    modes."""
    from tpu_search_torch.ops.ivf_scan import ivf_topk_plain, ivf_topk_scan

    st = ivf_state(dev, nlist=48, cap=256, d=96, seed=q + nprobe)
    b = st["rows"].to(dtype)
    sq = (b.float() ** 2).sum(-1)
    pen = torch.where(st["valid"], sq if metric == "l2" else 0.0,
                      float("inf"))
    gen = torch.Generator(device=dev).manual_seed(k + q)
    queries = torch.randn((q, 96), generator=gen, device=dev)
    queries[0] = b[0, 4].float()
    probe = torch.topk(queries @ st["cent"].T, nprobe).indices.int()
    alpha = 2.0 if metric == "l2" else 1.0
    ks, ki = ivf_topk_scan(b, pen, st["fills"], probe, queries, k, alpha)
    ps, pi = ivf_topk_plain(b, pen, st["fills"], probe, queries, k, alpha)
    torch.cuda.synchronize()
    assert ks.shape == (q, k)
    assert torch.equal(torch.isfinite(ks), torch.isfinite(ps))
    fin = torch.isfinite(ps)
    assert float((ks[fin] - ps[fin]).abs().max()) <= 1e-4
    assert bool(((ki == pi) | ((ks - ps).abs() <= 1e-4)).all())
    assert bool(st["valid"].reshape(-1)[ki[ki >= 0].long()].all())


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name", sorted(ivf_prep_cases.CASES))
def test_ivf_float_prep_kernel_equals_plain(dev, name, bf16):
    """The bf16 / f32 scan's prologue kernel against its plain twin, bit
    for bit (the bf16 cast, the table, the schedule, the member lists)."""
    from tpu_search_torch.ops.ivf_scan import (
        ivf_float_prep,
        ivf_float_prep_plain,
    )

    probe, fills, queries, _, cap = ivf_prep_cases.make_case(name)
    cpu = [torch.from_numpy(a) for a in (probe, fills, queries)]
    want = ivf_float_prep_plain(*cpu, cap, bf16)
    got = ivf_float_prep(*[t.to(dev) for t in cpu], cap, bf16)
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if value is None:
            assert got[key] is None
        else:
            assert torch.equal(got[key].cpu(), value), key


@pytest.mark.parametrize("name", sorted(ivf_prep_cases.CASES))
def test_flat_int8_prep_kernel_equals_plain(dev, name):
    """The flat int8 scan's prologue kernel (no nibble offsets) against
    its plain twin, bit for bit, on the queries of the IVF prologue
    cases."""
    from tpu_search_torch.ops.flat_topk_int8 import (
        flat_int8_prep,
        flat_int8_prep_plain,
    )

    queries = torch.from_numpy(ivf_prep_cases.make_case(name)[2])
    want = flat_int8_prep_plain(queries)
    got = flat_int8_prep(queries.to(dev))
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key].cpu(), value), key


@pytest.mark.parametrize("name", sorted(ivf_prep_cases.CASES))
def test_flat_int4_prep_kernel_equals_plain(dev, name):
    """The flat int4 scan's prologue kernel against its plain twin, bit
    for bit, on the queries of the IVF prologue cases."""
    from tpu_search_torch.ops.flat_topk_int4 import (
        flat_digit_prep,
        flat_digit_prep_plain,
    )

    queries = torch.from_numpy(ivf_prep_cases.make_case(name)[2])
    want = flat_digit_prep_plain(queries)
    got = flat_digit_prep(queries.to(dev))
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key].cpu(), value), key


def digit_scans(st, kind):
    """``(corpus args, kernel, plain)`` of the int8 or int4 probe scan."""
    from tpu_search_torch.ops import ivf_scan

    if kind == "int8":
        return ((st["i8"], st["s8"]), ivf_scan.ivf_topk_int8_scan,
                ivf_scan.ivf_topk_int8_plain)
    return ((st["nib"], st["s4"]), ivf_scan.ivf_topk_int4_scan,
            ivf_scan.ivf_topk_int4_plain)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("q,nprobe,k,nlist,schedule", [
    (1, 3, 10, 9, "probed"), (8, 9, 128, 9, "probed"), (33, 4, 77, 9, "probed"),
    (2, 5, 250, 9, "probed"),
    # the live schedule empty (only the empty cluster probed), shorter than
    # the grid's runs, and many times longer (nlist 4099)
    (3, 1, 10, 9, "empty"), (40, 1, 128, 9, "empty"), (1, 1, 128, 9, "probed"),
    (40, 64, 10, 4099, "probed"), (128, 16, 128, 4099, "probed"),
    (5, 400, 250, 4099, "probed")])
def test_ivf_quant_kernels_exact(dev, kind, residual, q, nprobe, k, nlist,
                                 schedule):
    st = ivf_state(dev, nlist=nlist, cap=512 if nlist < 100 else 256,
                   d=128 if nlist < 100 else 64, seed=q + nprobe)
    pen = torch.where(st["valid"], 0.0, float("-inf"))
    queries = torch.randn((q, st["cent"].shape[1]), device=dev)
    cs = queries @ st["cent"].T
    probe = torch.topk(cs, nprobe).indices.int()
    if schedule == "empty":
        probe[:] = 2  # fills[2] == 0
    cbias = torch.gather(cs, 1, probe.long()) if residual else None
    args, kernel, plain = digit_scans(st, kind)
    ks, ki = kernel(*args, pen, st["fills"], probe, queries, k, cbias)
    ps, pi = plain(*args, pen, st["fills"], probe, queries, k, cbias)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(ki, pi)
    if schedule == "empty":
        assert torch.isneginf(ks).all() and (ki == -1).all()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_ivf_quant_tie_at_k128(dev, kind):
    """Slots 4 and 9 of cluster 0 hold one row (one code, one scale): at
    k = 128 the lower slot comes first, as in the plain version."""
    st = ivf_state(dev)
    pen = torch.where(st["valid"], 0.0, float("-inf"))
    queries = torch.randn((3, 128), device=dev)
    queries[0] = st["rows"][0, 4]
    cs = queries @ st["cent"].T
    probe = torch.topk(cs, 3).indices.int()
    probe[0] = torch.tensor([0, 1, 3], dtype=torch.int32, device=dev)
    cbias = torch.gather(cs, 1, probe.long())
    args, kernel, plain = digit_scans(st, kind)
    ks, ki = kernel(*args, pen, st["fills"], probe, queries, 128, cbias)
    ps, pi = plain(*args, pen, st["fills"], probe, queries, 128, cbias)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(ki, pi)
    assert ks[0, 0] == ks[0, 1] and ki[0, :2].tolist() == [4, 9]


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("name", sorted(ivf_prep_cases.CASES))
def test_ivf_prep_kernel_equals_plain(dev, name, int4):
    """The digit scans' prologue kernel against its plain twin, bit for bit,
    on the cases of ``tests/test_torch_ivf_prep.py``."""
    from tpu_search_torch.ops.ivf_scan import (
        ivf_digit_prep,
        ivf_digit_prep_plain,
    )

    probe, fills, queries, cbias, cap = ivf_prep_cases.make_case(name)
    cpu = [torch.from_numpy(a) if a is not None else None
           for a in (probe, fills, queries, cbias)]
    want = ivf_digit_prep_plain(*cpu, cap, int4)
    got = ivf_digit_prep(*[t.to(dev) if t is not None else None for t in cpu],
                         cap, int4)
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if value is None:
            assert got[key] is None
        else:
            assert torch.equal(got[key].cpu(), value), key


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
                                     (128, 3, 120), (192, 2, 64),
                                     (256, 2, 13), (64, 12, 26)])
def test_attention_bhsd_kernel(dev, s, nh, hd):
    """The ``[B, heads, S, hd]`` kernel: padded head columns copied 4 bytes
    at a time (hd 26, at S 512 and at the S 64 bucket), 16 (hd 8, 120) or
    by plain stores (hd 13), and the unpadded path (hd 32, 64); a padded
    row and a fully padded one; the gates of ``chip_smoke.attention_ok``."""
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


@pytest.mark.parametrize("s,hd,nh,b", [
    (128, 64, 3, 4), (256, 26, 2, 4), (384, 32, 2, 4), (512, 128, 2, 4),
    (256, 8, 2, 4), (128, 26, 2, 1), (128, 32, 2, 5), (128, 128, 1, 3),
    (256, 64, 2, 1), (256, 128, 2, 5), (512, 26, 2, 5), (512, 32, 2, 3),
    (512, 64, 2, 5), (256, 25, 2, 5), (128, 40, 2, 3), (128, 160, 2, 3),
    (128, 193, 1, 2), (256, 256, 2, 3)])
def test_flash_attention_kernel(dev, s, hd, nh, b):
    """The stock-flash kernel against its plain version: one block (S 128)
    and several, head sizes padded to 16 and not (16-byte, 4-byte and, at
    odd hd, 2-byte row copies), above 128 (the wide kernel: hd 160 and an
    odd 193 at S 128, 256 at S 256), B 1 and odd B, a trained-scale bias, a
    padded tail, a mostly padded row, a fully padded one and one that is
    all pad but one key."""
    from chip_smoke import attention_ok, bf16_errors
    from tpu_search_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(s + hd + b)
    q, k, v = (torch.randn((b, nh, s, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ab = (2.0 * torch.randn((nh, s, s), generator=gen, device=dev)).to(
        torch.bfloat16)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    for row, live in ((1, s // 3), (2, 3), (3, 0), (4, 1))[:b - 1]:
        seg[row, live:] = 0
    scale = 1.0 / math.sqrt(hd)
    out = flash_attention(q, k, v, ab, seg, seg, scale)
    ref = flash_attention_plain(q, k, v, ab, seg, seg, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    errors = bf16_errors(out, ref)
    assert attention_ok(errors, "flash_attention"), errors


@pytest.mark.parametrize("s,hd,error,match", [
    (64, 64, ValueError, "block_q"), (192, 64, ValueError, "divisible"),
    (256, 160, NotImplementedError, "multiple of 128"),
    (256, 320, NotImplementedError, "multiple of 128")])
def test_flash_attention_refuses_shapes(dev, s, hd, error, match):
    """The card refuses what the stock kernel refuses, with its error
    (a head size above 128 that is not a multiple of 128 at S > 128:
    NotImplementedError), and nothing else: it has no head-size limit of
    its own."""
    from tpu_search_torch.ops.flash_attention import flash_attention

    q = torch.zeros((1, 2, s, hd), dtype=torch.bfloat16, device=dev)
    ab = torch.zeros((2, s, s), dtype=torch.bfloat16, device=dev)
    seg = torch.ones((1, s), dtype=torch.int32, device=dev)
    with pytest.raises(error, match=match):
        flash_attention(q, q, q, ab, seg, seg, 1.0)


def flash_case(dev, dtype, s, hd, nh, b, seed):
    """q, k, v, dO ``[B, heads, S, hd]``, a trained-scale bias and segment
    ids with a padded tail, a mostly padded row, a fully padded one and one
    that is all pad but one key (as ``test_flash_attention_kernel``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, nh, s, hd), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    ab = (2.0 * torch.randn((nh, s, s), generator=gen, device=dev)).to(dtype)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    for row, live in ((1, s // 3), (2, 3), (3, 0), (4, 1))[:b - 1]:
        seg[row, live:] = 0
    return q, k, v, do, ab, seg


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hd,nh,b", [
    (128, 64, 3, 4), (256, 26, 2, 4), (384, 32, 2, 5), (512, 128, 1, 3),
    (256, 8, 2, 5), (128, 25, 2, 3), (256, 48, 2, 2), (128, 160, 2, 3),
    (256, 256, 1, 3), (256, 64, 2, 40), (1024, 64, 1, 2)])
def test_flash_attention_bwd_kernel(dev, dtype, s, hd, nh, b):
    """``flash_attention_bwd.cu`` against ``flash_attention_bwd_plain`` on
    the card, from one forward's output and residuals: one block (S 128)
    and several, head sizes 8 to 256 (25 odd, 26 not a multiple of 4, 48
    padded to 64, 160 and 256 split into two column halves), padded rows,
    B 40 (two batch groups of the bf16 bias's gradient), S 1024 (the bf16
    row pass's keys in chunks); dQ, dK, dV and dab within
    ``chip_smoke.flash_bwd_ok``, one C call; no dab without ``ab_grad``,
    and the same dQ, dK, dV."""
    from chip_smoke import flash_bwd_errors, flash_bwd_ok
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    q, k, v, do, ab, seg = flash_case(dev, dtype, s, hd, nh, b, s + hd + b)
    scale = 1.0 / math.sqrt(hd)
    out, m, l = flash_attention_fwd(q, k, v, ab, seg, seg, scale)
    before = _build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, ab, seg, seg, out, do, m, l, scale)
    want = flash_attention_bwd_plain(q, k, v, ab, seg, seg, out, do, m, l,
                                     scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    name = "float32" if dtype == torch.float32 else "bfloat16"
    for what, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape, what
        assert torch.isfinite(g.float()).all(), what
        errors = flash_bwd_errors(g, w, name)
        assert flash_bwd_ok(errors, name), (what, errors)
    bare = flash_attention_bwd(q, k, v, ab, seg, seg, out, do, m, l, scale,
                               ab_grad=False)
    torch.cuda.synchronize()
    assert bare[3] is None
    for g, w in zip(bare[:3], got[:3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("s,hd,nh,b", [
    (128, 64, 3, 4), (256, 26, 2, 4), (384, 32, 2, 5), (512, 128, 1, 3),
    (256, 8, 2, 5), (128, 13, 2, 3), (128, 160, 2, 3), (256, 256, 1, 3)])
def test_flash_attention_f32_kernel(dev, s, hd, nh, b):
    """``flash_attention_f32.cu`` against the plain forward on f32 inputs:
    the output within ``chip_smoke.ATTN_F32_TOL``, and with residuals each
    row's ``(m, l)`` within it relative to the plain ones; one launch a
    call, the same output with and without residuals."""
    from chip_smoke import ATTN_F32_TOL
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )

    q, k, v, _, ab, seg = flash_case(dev, torch.float32, s, hd, nh, b, s + hd)
    scale = 1.0 / math.sqrt(hd)
    before = _build.LAUNCHES["flash_attention_f32"]
    out = flash_attention(q, k, v, ab, seg, seg, scale)
    got = flash_attention_fwd(q, k, v, ab, seg, seg, scale)
    want = flash_attention_fwd_plain(q, k, v, ab, seg, seg, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_f32"] == before + 2
    assert torch.isfinite(out).all() and torch.equal(out, got[0])
    assert float((out - want[0]).abs().max()) <= ATTN_F32_TOL
    for g, w in zip(got[1:], want[1:]):
        assert float(((g - w).abs() / w.abs().clamp(min=1.0)).max()) <= (
            ATTN_F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hd,nh,b", [(128, 300, 2, 3), (128, 320, 1, 2),
                                       (256, 384, 1, 2), (256, 512, 2, 2)])
def test_flash_attention_above_256(dev, dtype, s, hd, nh, b):
    """Head sizes above 256, as the stock kernel takes them (any at S 128,
    multiples of 128 above): the forward of q's dtype (bf16: the wide
    kernel's head chunks; f32: the tf32 kernel's) within its gate of the
    plain version, and the backward (the tf32 passes in both dtypes) within
    ``chip_smoke.flash_bwd_ok``, one launch each."""
    from chip_smoke import (
        ATTN_F32_TOL,
        attention_ok,
        bf16_errors,
        flash_bwd_errors,
        flash_bwd_ok,
    )
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )

    q, k, v, do, ab, seg = flash_case(dev, dtype, s, hd, nh, b, s + hd)
    scale = 1.0 / math.sqrt(hd)
    fwd = "flash_attention" if dtype == torch.bfloat16 else (
        "flash_attention_f32")
    before = dict(_build.LAUNCHES)
    out, m, l = flash_attention_fwd(q, k, v, ab, seg, seg, scale)
    ref, pm, pl = flash_attention_fwd_plain(q, k, v, ab, seg, seg, scale)
    got = flash_attention_bwd(q, k, v, ab, seg, seg, out, do, m, l, scale)
    want = flash_attention_bwd_plain(q, k, v, ab, seg, seg, out, do, m, l,
                                     scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fwd] == before[fwd] + 1
    assert (_build.LAUNCHES["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    assert torch.isfinite(out.float()).all()
    if dtype == torch.bfloat16:
        errors = bf16_errors(out, ref)
        assert attention_ok(errors, "flash_attention"), errors
    else:
        assert float((out - ref).abs().max()) <= ATTN_F32_TOL
    for g, w in ((m, pm), (l, pl)):
        assert float(((g - w).abs() / w.abs().clamp(min=1.0)).max()) <= 1e-5
    name = "float32" if dtype == torch.float32 else "bfloat16"
    for what, g, w in zip(("dq", "dk", "dv", "dab"), got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape, what
        assert torch.isfinite(g.float()).all(), what
        errors = flash_bwd_errors(g, w, name)
        assert flash_bwd_ok(errors, name), (what, errors)


def test_flash_attention_bwd_f32_workspace_is_small(dev):
    """The f32 backward's workspace at B 128, 12 heads, S 384 with a bias
    gradient: at most an eighth of a [B, heads, S, S] f32 scratch (the
    groups' partials: B / 16 of them)."""
    from tpu_search_torch.ops.flash_attention import _workspace_bytes

    b, nh, s = 128, 12, 384
    nbytes = _workspace_bytes(b, nh, s, 64, False, True)
    assert 0 < nbytes <= b * nh * s * s * 4 // 8, nbytes
    assert _workspace_bytes(b, nh, s, 64, False, False) < nbytes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hd,b", [(384, 64, 40), (256, 256, 3)])
def test_flash_attention_bwd_repeats(dev, dtype, s, hd, b):
    """Two calls of the backward give the same bits: no atomics, every
    sum in a fixed order (the bias's gradient over two batch groups and
    their partials at B 40, in bf16 and f32)."""
    from tpu_search_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    q, k, v, do, ab, seg = flash_case(dev, dtype, s, hd, 2, b, 7)
    scale = 1.0 / math.sqrt(hd)
    out, m, l = flash_attention_fwd(q, k, v, ab, seg, seg, scale)
    first = flash_attention_bwd(q, k, v, ab, seg, seg, out, do, m, l, scale)
    second = flash_attention_bwd(q, k, v, ab, seg, seg, out, do, m, l, scale)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv", "dab"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_grad_runs_the_kernels(dev, dtype):
    """Under grad the flash attention runs its forward kernel of q's dtype
    with residuals and the backward kernel, once each, and the gradients
    agree with the plain forward and backward on the card; the bf16
    forward's residuals agree with the plain ones."""
    from chip_smoke import flash_bwd_errors, flash_bwd_ok
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )

    q, k, v, do, ab, seg = flash_case(dev, dtype, 256, 64, 2, 3, 9)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, ab)]
    fwd = "flash_attention" if dtype == torch.bfloat16 else (
        "flash_attention_f32")
    before = dict(_build.LAUNCHES)
    flash_attention(*leaves, seg, seg, 0.125).backward(do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fwd] == before[fwd] + 1
    assert (_build.LAUNCHES["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    out, m, l = flash_attention_fwd(q, k, v, ab, seg, seg, 0.125)
    _, pm, pl = flash_attention_fwd_plain(q, k, v, ab, seg, seg, 0.125)
    assert float((m - pm).abs().max()) <= 1e-5 * float(pm.abs().max())
    assert float(((l - pl).abs() / pl).max()) <= 1e-5
    want = flash_attention_bwd_plain(q, k, v, ab, seg, seg, out, do, m, l,
                                     0.125)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    for leaf, w in zip(leaves, want):
        errors = flash_bwd_errors(leaf.grad, w, name)
        assert flash_bwd_ok(errors, name), errors


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


# -- the fused query path as CUDA graphs -------------------------------------


@pytest.fixture(scope="module")
def graph_engine(tmp_path_factory):
    """A flat bf16 engine on the card: all-mpnet-base-v2's widths at two
    layers (random, seeded), 12 synthetic conversations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.models.convert import save_checkpoint
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params
    from tpu_search_torch.utils.synthetic import write_conversations

    root = tmp_path_factory.mktemp("graphs")
    config = MPNetConfig(num_layers=2, vocab_size=512)
    model_dir = root / "data" / "models" / "graph-mpnet"
    model_dir.mkdir(parents=True)
    save_checkpoint(str(model_dir / "model.tpu.npz"), init_params(config, 9),
                    config)
    (model_dir / "vocab.txt").write_text("\n".join(
        ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"]
        + [f"tok{i}" for i in range(config.vocab_size - 5)]) + "\n")
    files = write_conversations(root, 14, config.vocab_size - 5)
    engine = SearchEngine(str(root / "data"), model_name="graph-mpnet",
                          use_warm_server=False, device="cuda")
    engine.index_conversations(files[:12])
    return engine, files[12:]


def _probe_texts(engine, n):
    storage = engine.storage
    ids = sorted(storage.chunk_id_to_faiss_id)[:n]
    return [storage.get_chunk_by_id(cid).text for cid in ids], ids


@pytest.mark.parametrize("q", [1, 8, 9, 32])
def test_fused_graph_replay_equals_eager(dev, graph_engine, q):
    """A replayed window equals the same window run eagerly (no graph),
    at q_pad 8 and 32, unfiltered and filtered."""
    from tpu_search_torch.api.fused import Window, run_eager
    from tpu_search_torch.storage.hybrid import SearchConfig

    engine, _ = graph_engine
    texts, _ = _probe_texts(engine, q)
    for filters in (None, {"has_code": True}):
        cfg = SearchConfig(top_k=10)
        for _ in range(2):  # the capture, then a replay of the cached graph
            window = engine._fused_window(texts, filters, cfg)
            assert isinstance(window, Window)
            pending = engine._fused_dispatch_many(texts, filters, cfg)
            pending.event.synchronize()
            eager = run_eager(window).cpu()
            assert torch.equal(pending.packed, eager)


def test_fused_graph_sees_an_add_and_a_remove(dev, graph_engine):
    """Rows added and removed between two replays of one graph are seen by
    the second (the scan reads the capacity and a staged penalty), with no
    new capture while the capacity holds."""
    from tpu_search_torch.storage.hybrid import SearchConfig

    engine, (first, second) = graph_engine
    storage = engine.storage
    cfg = SearchConfig(top_k=5)
    capacity = storage.index.capacity

    def add(path):
        before = set(storage.chunk_id_to_faiss_id)
        engine.index_conversations([path])
        new_ids = sorted(set(storage.chunk_id_to_faiss_id) - before)
        assert new_ids
        return new_ids[0]

    def top(text):
        return [(r.chunk_id, r.similarity) for r in
                engine._fused_search_many([text], None, cfg)[0]]

    new_id = add(first)
    text = storage.get_chunk_by_id(new_id).text
    got = top(text)  # may capture this text's sequence bucket
    assert got[0][0] == new_id and abs(got[0][1] - 1.0) < 1e-2
    captures = engine._fused.captures
    other = add(second)  # an add between two replays of text's graph
    assert top(text)[0][0] == new_id
    assert engine._fused.captures == captures
    assert top(storage.get_chunk_by_id(other).text)[0][0] == other
    captures = engine._fused.captures  # other's bucket may have captured
    storage.remove_chunks_for_files([str(first)])  # a remove
    assert new_id not in [cid for cid, _ in top(text)]
    assert engine._fused.captures == captures  # same graphs, replayed
    assert storage.index.capacity == capacity


def test_fused_graph_concurrent_dispatches(dev, graph_engine):
    """8 threads dispatch windows of one graph at once; each collects its
    own result, equal to the same query's result alone."""
    import threading

    from tpu_search_torch.storage.hybrid import SearchConfig

    engine, _ = graph_engine
    cfg = SearchConfig(top_k=5)
    texts = [f"tok{i} tok{i + 5} tok{i + 9}" for i in range(8)]
    alone = [[(r.chunk_id, r.similarity) for r in
              engine._fused_search_many([t], None, cfg)[0]] for t in texts]
    got = [None] * len(texts)
    start = threading.Barrier(len(texts))

    def client(i):
        start.wait(timeout=60)
        pending = engine._fused_dispatch_many([texts[i]], None, cfg)
        got[i] = [(r.chunk_id, r.similarity)
                  for r in engine._fused_collect(pending, cfg)[0]]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == alone


def _window_over(engine, tmp_path, devices, texts, cfg):
    """The engine's flat index saved and loaded as a ``ShardedFlatIndex``
    with one shard on each of ``devices``; the window of ``texts`` over
    it, with the sharded scan's card plan even where the shards share a
    card (the program of several cards, then, on one)."""
    import dataclasses

    from tpu_search_torch.parallel import ShardedFlatIndex, build_mesh
    from tpu_search_torch.parallel.sharded_index import card_plan

    storage = engine.storage
    path = str(tmp_path / "cards.idx")
    storage.index.save(path)
    mesh = build_mesh(n_data=len(devices), devices=devices)
    index = ShardedFlatIndex.load(path, mesh)
    kept, storage.index = storage.index, index
    try:
        window = engine._fused_window(texts, None, cfg)
    finally:
        storage.index = kept
    return index, dataclasses.replace(window, plan=card_plan)


@pytest.mark.parametrize("cards", [1, 2])
def test_fused_window_over_cards(dev, graph_engine, tmp_path, cards):
    """The window over shards on ``cards`` cards (two shards a card) as
    the program of several cards: one graph on the encoder's card, one a
    card, one merge.  A replay equals its eager run bit for bit (twice:
    the capture, then the cached program) and one card's fused answer
    (scores within 1e-4, ids equal outside near-ties); a replay adds one
    scan launch a shard.  ``cards`` 2 skips below two cards."""
    from tpu_search_torch.api.fused import run_eager
    from tpu_search_torch.ops import _build
    from tpu_search_torch.storage.hybrid import SearchConfig

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    engine, _ = graph_engine
    texts, _ = _probe_texts(engine, 9)
    cfg = SearchConfig(top_k=10)
    devices = [torch.device("cuda", i % cards) for i in range(2 * cards)]
    one = engine._fused_fetch(engine._fused_dispatch_many(texts, None, cfg))
    index, window = _window_over(engine, tmp_path, devices, texts, cfg)
    for replay in (False, True):  # the capture, then the cached program
        before = _build.LAUNCHES["flat_topk"]
        packed, event = engine._fused.dispatch(window)
        event.synchronize()
        if replay:  # a replay adds the captured launches, one a shard
            assert _build.LAUNCHES["flat_topk"] - before == len(devices)
        eager = run_eager(window).cpu()
        assert torch.equal(packed, eager)
    k = window.k
    scores, ids = packed[:9, :k].numpy(), packed[:9, k:].long().numpy()
    assert abs(scores - one[0]).max() <= 1e-4
    for r in range(9):
        for j in (ids[r] != one[1][r]).nonzero()[0]:
            assert abs(scores[r, j] - one[0][r, j]) <= 1e-4
    assert torch.cuda.current_device() == 0
    del index


def test_fused_window_gathering_under_a_one_rank_group(
        dev, graph_engine, tmp_path, monkeypatch):
    """The window over two shards on the card under a one-rank NCCL group:
    the mesh gathers, so the program holds the stage's gather as a step of
    its own between two graph replays (``_capture_cards``).  The capturing
    dispatch (answered from the capture's warm pass) and a replay of the
    cached program each equal the eager run bit for bit and the same window
    without the group (ids equal, scores within 1e-6), and each makes one
    gather: an ``all_gather`` of the stage's scores and one of its ids."""
    import torch.distributed as dist

    from tpu_search_torch.api.fused import run_eager
    from tpu_search_torch.parallel.sharded_index import gather_ranks
    from tpu_search_torch.storage.hybrid import SearchConfig

    engine, _ = graph_engine
    texts, _ = _probe_texts(engine, 9)
    cfg = SearchConfig(top_k=10)
    index, window = _window_over(engine, tmp_path, [dev, dev], texts, cfg)
    ungrouped = run_eager(window).cpu()
    del index
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/group",
                            rank=0, world_size=1)
    calls = []
    real = dist.all_gather

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    try:
        index, window = _window_over(engine, tmp_path, [dev, dev], texts,
                                     cfg)
        plan = window.plan(window.scan_key, window.buffers, window.staged,
                           window.k, merge_device=window.device)
        assert [s.collective for s in plan.stages] == [gather_ranks]
        monkeypatch.setattr(dist, "all_gather", counted)
        for replay in (False, True):  # the capture, then the cached program
            captures = engine._fused.captures
            calls.clear()
            packed, event = engine._fused.dispatch(window)
            event.synchronize()
            assert len(calls) == 2
            assert engine._fused.captures == captures + (not replay)
            calls.clear()
            eager = run_eager(window).cpu()
            assert len(calls) == 2  # the eager run gathers too
            assert torch.equal(packed, eager)
            k = window.k
            assert torch.equal(packed[:, k:], ungrouped[:, k:])
            assert (packed[:, :k] - ungrouped[:, :k]).abs().max() <= 1e-6
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
        engine._fused.clear()
    del index


@pytest.mark.parametrize("opq", [False, True])
def test_pq_search_on_the_card_and_in_a_graph(dev, tmp_path, opq):
    import numpy as np

    from tpu_search_torch.index.ivf import IVFIndex, ivf_scan
    from tpu_search_torch.index.registry import load_index

    rng = np.random.default_rng(0)
    rows = rng.standard_normal((20000, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    cpu = IVFIndex(64, dtype="pq", nlist=16, opq=opq, device="cpu")
    cpu.add(rows)
    cpu.remove(np.arange(0, 20000, 9))
    cpu.save(str(tmp_path / "pq.idx"))
    card = load_index(str(tmp_path / "pq.idx"), device=dev)
    for q in (1, 8, 32):
        queries = rows[:q] + 0.01
        for k in (10, 200):
            ws, wi = cpu.search(queries, k, nprobe=8)
            gs, gi = card.search(queries, k, nprobe=8)
            fin = np.isfinite(ws)
            assert (np.isfinite(gs) == fin).all()
            assert np.abs(gs[fin] - ws[fin]).max() <= 1e-5
            assert ((gi == wi) | (np.abs(gs - ws) <= 1e-5)).all()
    scan_key, buffers = card.make_scan_fn(8)
    staged = card.scan_staged(None)
    static = torch.from_numpy(rows[:8] + 0.01).to(dev)
    want = ivf_scan(scan_key, buffers, staged, static, 10)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ivf_scan(scan_key, buffers, staged, static, 10)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ivf_scan(scan_key, buffers, staged, static, 10)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def attention_case(dev, layout, b, s, nh, hd, dtype, seed):
    """q, k, v and an output gradient in ``layout``, a trained-scale bias
    and a mask with a row padded by -inf, one by the f32 min and one
    fully -inf (the forward's uniform row)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, s, nh * hd) if layout == "bsh" else (b, nh, s, hd)
    q, k, v, grad = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(4))
    bias = 0.5 * torch.randn((nh, s, s), generator=gen, device=dev)
    mask = torch.zeros((b, s), device=dev)
    mask[1, s // 3 + 1:] = float("-inf")
    mask[2, s // 2 + 1:] = torch.finfo(torch.float32).min
    mask[3] = float("-inf")
    return q, k, v, grad, bias, mask


@pytest.mark.parametrize("layout,s,nh,hd,dtype", [
    ("bhsd", 100, 3, 13, torch.bfloat16),
    ("bhsd", 64, 4, 8, torch.float32),
    ("bhsd", 512, 2, 128, torch.bfloat16),
    ("bhsd", 17, 2, 26, torch.float32),
    ("bsh", 200, 2, 64, torch.bfloat16),
    ("bsh", 33, 4, 32, torch.float32),
    ("bsh", 1, 2, 64, torch.bfloat16),
    ("bhsd", 1500, 1, 128, torch.bfloat16),
    ("bsh", 777, 2, 48, torch.float32),
])
def test_attention_bwd_kernel(dev, layout, s, nh, hd, dtype):
    """``mpnet_attention_bwd.cu`` against ``mpnet_attention_bwd_plain`` at
    S off its 64-row and 64 / 32-key tiles (1, 17, 33, 100, 200, 777) and
    past the old row passes' shared-memory cap (1,500 at hd 128), head dims
    8 to 128 (13 and 26 not a multiple of 4, 48 padded to 64), both layouts
    and dtypes, with
    padded, min-padded and fully -inf rows: one C call, dQ, dK, dV and
    dBias within ``chip_smoke.grad_gate`` of the plain twin, zero dQ on
    the -inf row, and no dBias when the bias needs none."""
    from chip_smoke import grad_gate, rel_errors
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention_bwd,
        mpnet_attention_bwd_plain,
    )

    q, k, v, grad, bias, mask = attention_case(dev, layout, 5, s, nh, hd,
                                               dtype, s * hd)
    heads = nh if layout == "bsh" else None
    scale = 1.0 / math.sqrt(hd)
    before = _build.LAUNCHES["mpnet_attention_bwd"]
    got = mpnet_attention_bwd(q, k, v, grad, bias, mask, scale, heads)
    want = mpnet_attention_bwd_plain(q, k, v, grad, bias, mask, scale, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mpnet_attention_bwd"] == before + 1
    name = "float32" if dtype == torch.float32 else "bfloat16"
    for what, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.isfinite(g.float()).all(), what
        errors = rel_errors(g, w)
        assert grad_gate(errors, "float32" if what == "dbias" else name,
                         auto=False), (what, errors)
    dq = got[0] if layout == "bhsd" else got[0].reshape(5, s, nh, hd)
    assert not dq[3].any()
    assert mpnet_attention_bwd(q, k, v, grad, bias, mask, scale, heads,
                               bias_grad=False)[3] is None


@pytest.mark.parametrize("layout,s,nh,hd", [
    ("bhsd", 100, 3, 13), ("bhsd", 1, 1, 128), ("bsh", 77, 4, 32),
    ("bsh", 384, 12, 64), ("bhsd", 3000, 2, 128),
])
def test_attention_f32_kernel(dev, layout, s, nh, hd):
    """``mpnet_attention_f32.cu`` through the wrappers (f32 q, k, v) against
    the plain versions at ragged S (and S 3,000 at hd 128, past the old
    row pass's cap), with padded and fully -inf rows: within
    ``chip_smoke.ATTN_F32_TOL``, one launch, finite."""
    from chip_smoke import ATTN_F32_TOL
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention,
        mpnet_attention_bhsd,
        mpnet_attention_bhsd_plain,
        mpnet_attention_plain,
    )

    q, k, v, _, bias, mask = attention_case(dev, layout, 5, s, nh, hd,
                                            torch.float32, s + hd)
    scale = 1.0 / math.sqrt(hd)
    before = _build.LAUNCHES["mpnet_attention_f32"]
    if layout == "bsh":
        out = mpnet_attention(q, k, v, bias, mask, nh, scale)
        ref = mpnet_attention_plain(q, k, v, bias, mask, nh, scale)
    else:
        out = mpnet_attention_bhsd(q, k, v, bias, mask, scale)
        ref = mpnet_attention_bhsd_plain(q, k, v, bias, mask, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mpnet_attention_f32"] == before + 1
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= ATTN_F32_TOL


def test_attention_function_runs_the_kernels_under_grad(dev):
    """With grad, ``mpnet_attention`` is ``MPNetAttention``: the forward
    kernel, then the backward kernel, giving autograd's gradient of the
    plain forward within the gates; without grad, no graph."""
    from chip_smoke import grad_gate, rel_errors
    from tpu_search_torch.ops import _build
    from tpu_search_torch.ops.mpnet_attention import (
        mpnet_attention,
        mpnet_attention_plain,
    )

    q, k, v, grad, bias, mask = attention_case(dev, "bsh", 4, 128, 2, 64,
                                               torch.bfloat16, 7)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    before = dict(_build.LAUNCHES)
    out = mpnet_attention(*leaves, mask, 2, 0.125)
    out.backward(grad)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mpnet_attention"] == before["mpnet_attention"] + 1
    assert (_build.LAUNCHES["mpnet_attention_bwd"]
            == before["mpnet_attention_bwd"] + 1)
    plain = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    mpnet_attention_plain(*plain, mask, 2, 0.125).backward(grad)
    # autograd rounds dP to bf16, which reaches the f32 dBias through dS:
    # every gradient takes the bf16 gate against it
    for a, b in zip(leaves, plain):
        assert grad_gate(rel_errors(a.grad, b.grad), "bfloat16", auto=True)
    with torch.no_grad():
        assert mpnet_attention(*leaves, mask, 2, 0.125).grad_fn is None
