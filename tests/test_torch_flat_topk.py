"""The port's exact masked top-k (plain version) against the JAX package's
Pallas DMA kernel (interpret mode) and its XLA ``flat_topk``; the CUDA
scan's host side: its run planner (``ops/ring_scan.py`` ``scan_runs`` at a
faked multiprocessor count, each run's tiles as the kernel's ``run_begin``
splits them) and its prologue's plain
twin against the JAX package's bf16 cast, bit for bit.

Tolerance: scores within 1e-5 (f32 sums of D products in another order;
the inputs are unit-norm, so scores are O(1)).  Ids must be identical:
the random inputs carry no near-ties, and the planted exact ties must
resolve to the lower row id, as the TPU kernel's selection does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.ops.pallas_topk_dma import pallas_flat_topk_dma
from tpu_search.ops.topk_scan import flat_topk as jax_flat_topk
from tpu_search_torch.index.flat import flat_scan
from tpu_search_torch.ops import _build
from tpu_search_torch.ops.flat_topk import (
    flat_float_prep,
    flat_float_prep_plain,
    flat_topk_scan,
)
from tpu_search_torch.ops.ring_scan import TILE, float_block, scan_runs
from tpu_search_torch.ops.topk_scan import (
    flat_topk,
    flat_topk_plain,
    row_penalty,
    row_sq_norms,
)
from tpu_search_torch.utils.shapes import cdiv

TOL = 1e-5


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def corpus(rng, n, d, dtype):
    v = rng.standard_normal((n, d)).astype(np.float32) * rng.uniform(
        0.5, 2.0, size=(n, 1)
    ).astype(np.float32)
    jv = jnp.asarray(v).astype(jnp.bfloat16 if dtype == "bfloat16" else
                                jnp.float32)
    tv = torch.from_numpy(v).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32
    )
    return jv, tv


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [10, 128])
def test_plain_matches_pallas_and_xla(metric, dtype, k):
    rng = np.random.default_rng(0)
    n, d, q = 2048, 128, 8
    jv, tv = corpus(rng, n, d, dtype)
    mask = rng.random(n) < 0.6
    queries = normed(rng, q, d)
    kwargs = {}
    if metric == "l2":
        v32 = jv.astype(jnp.float32)
        kwargs = dict(metric="l2", sq_norms=jnp.sum(v32 * v32, axis=1))
    ps, pi = pallas_flat_topk_dma(
        jv, jnp.asarray(mask), jnp.asarray(queries), k, tile_n=1024,
        interpret=True, **kwargs,
    )
    xs, xi = jax_flat_topk(jv, jnp.asarray(mask), jnp.asarray(queries), k,
                           metric=metric)
    ts, ti = flat_topk(tv, torch.from_numpy(mask), torch.from_numpy(queries),
                       k, metric=metric)
    for ref_s, ref_i in ((ps, pi), (xs, xi)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(ref_s),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ref_i))


def test_penalty_path_equals_mask_path():
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    mask = torch.from_numpy(rng.random(300) < 0.5)
    qs = torch.from_numpy(normed(rng, 3, 64))
    pen, alpha = row_penalty(mask, "l2", row_sq_norms(v))
    a = flat_topk_plain(v, pen, qs, 7, alpha)
    b = flat_topk(v, mask, qs, 7, metric="l2")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the CPU wrapper takes the plain version
    c = flat_topk_scan(v, pen, qs, 7, alpha)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_all_masked_rows_score_neg_inf_with_id_minus_one():
    rng = np.random.default_rng(2)
    n, d, k = 1024, 128, 16
    v = normed(rng, n, d)
    mask = np.zeros(n, dtype=bool)
    mask[[3, 700, 900]] = True  # fewer live rows than k
    queries = normed(rng, 8, d)
    ts, ti = flat_topk(torch.from_numpy(v), torch.from_numpy(mask),
                       torch.from_numpy(queries), k)
    ps, pi = pallas_flat_topk_dma(
        jnp.asarray(v), jnp.asarray(mask), jnp.asarray(queries), k,
        tile_n=1024, interpret=True,
    )
    ps, pi = np.asarray(ps), np.asarray(pi)
    live = np.isfinite(ps)
    assert live.sum(axis=1).tolist() == [3] * 8
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), live)
    np.testing.assert_array_equal(ti.numpy()[live], pi[live])
    assert (ti.numpy()[~live] == -1).all()
    assert np.isneginf(ts.numpy()[~live]).all()
    # every row masked
    ts, ti = flat_topk(torch.from_numpy(v), torch.zeros(n, dtype=torch.bool),
                       torch.from_numpy(queries), k)
    assert np.isneginf(ts.numpy()).all() and (ti.numpy() == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planted_ties_take_the_lower_row_id(dtype):
    rng = np.random.default_rng(3)
    n, d, k = 2048, 128, 12
    v = normed(rng, n, d)
    q = normed(rng, 8, d)
    # duplicate rows (exact score ties) on both sides of a tile boundary
    for src, dups in ((5, (6, 1500, 2047)), (40, (1023, 1024))):
        for dst in dups:
            v[dst] = v[src]
        q[0] = v[src]  # make the tied rows the top hits of query 0
        q[1] = v[src]
    mask = np.ones(n, dtype=bool)
    jv = jnp.asarray(v).astype(jnp.bfloat16 if dtype == "bfloat16" else
                               jnp.float32)
    tv = torch.from_numpy(v).to(torch.bfloat16 if dtype == "bfloat16" else
                                torch.float32)
    ts, ti = flat_topk(tv, torch.from_numpy(mask), torch.from_numpy(q), k)
    ps, pi = pallas_flat_topk_dma(jv, jnp.asarray(mask), jnp.asarray(q), k,
                                  tile_n=1024, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=TOL, atol=TOL)
    assert ti.numpy()[0, :3].tolist() == [40, 1023, 1024]


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    # A tensor that is neither on the CPU nor on CUDA is refused: the
    # wrapper never falls back to the plain version for it.
    with pytest.raises(ValueError, match="unsupported device"):
        flat_topk_scan(torch.zeros((256, 64), device="meta"),
                       torch.zeros(256, device="meta"),
                       torch.zeros((1, 64), device="meta"), 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [8, 16])
def test_v1_scan_cases_match_pallas_flat_topk(dtype, q):
    """The cases of ``tests/test_pallas_topk.py`` (the v1
    ``pallas_flat_topk``), built by ``chip_smoke.v1_scan_inputs`` as the
    card test of ``flat_topk.cu`` builds them: the plain version equals the
    v1 kernel here, and the CUDA kernel equals the plain version there."""
    from chip_smoke import v1_scan_inputs
    from tpu_search.ops.pallas_topk import pallas_flat_topk

    vecs, pen, queries, k = v1_scan_inputs("matches", dtype, q, "cpu")
    jv = jnp.asarray(vecs.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    mask = jnp.asarray((pen == 0).numpy())
    ps, pi = pallas_flat_topk(jv, mask, jnp.asarray(queries.numpy()), k,
                              tile_n=1024, interpret=True)
    ts, ti = flat_topk_scan(vecs, pen, queries, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=TOL, atol=TOL)

    vecs, pen, queries, k = v1_scan_inputs("masked_tile", "float32", 8, "cpu")
    _, pi = pallas_flat_topk(jnp.asarray(vecs.numpy()),
                             jnp.asarray((pen == 0).numpy()),
                             jnp.asarray(queries.numpy()), k, tile_n=1024,
                             interpret=True)
    _, ti = flat_topk_scan(vecs, pen, queries, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    assert (ti.numpy() < 1024).all()


def run_bounds(entries, runs):
    """The first entry of each run and the end of the last, as the scan
    CTAs compute them (``csrc/run_merge.cuh`` ``run_begin``): run ``r``
    takes the contiguous ``[entries r / runs, entries (r + 1) / runs)``."""
    return [entries * r // runs for r in range(runs + 1)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("n", [32768, 1_000_000, 4133])
def test_run_plan_covers_every_tile_once(monkeypatch, n, sms):
    """The ring scan's runs (the wrapper's ``scan_runs`` on a card of
    ``sms`` multiprocessors, the kernel's ``run_begin`` split): every
    128-row tile in exactly one run, runs contiguous and in row order,
    none empty, balanced to one tile, and no more runs than the card's
    CTAs over the query blocks or than tiles."""
    monkeypatch.setattr(_build, "multiprocessors", lambda dev: sms)
    tiles = cdiv(n, TILE)
    for q in (1, 8, 16, 17, 32, 40, 128):
        for bf16 in (True, False):
            blocks = cdiv(q, float_block(q, bf16))
            for ctas in (1, 2, 3):
                runs = scan_runs(ctas, blocks, tiles, "cuda")
                assert 1 <= runs <= min(tiles, max(1, sms * ctas // blocks))
                bounds = run_bounds(tiles, runs)
                assert len(bounds) == runs + 1
                assert bounds[0] == 0 and bounds[-1] == tiles
                sizes = np.diff(bounds)
                assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    # the fused path's capacity on an H100 (132 multiprocessors, 2-3 CTAs
    # each): one or two tiles a run, not one a 128-row CTA of fixed ranges
    if n == 32768 and sms == 132:
        assert run_bounds(tiles, scan_runs(2, 1, tiles, "cuda"))[1] <= 2


def bf16_halfway_queries(rng, q, d):
    """Queries whose low 16 bits sit on and around bf16 rounding ties
    (both parities), with zeros, subnormals and large magnitudes."""
    x = rng.standard_normal((q, d)).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:, 0::4] = (bits[:, 0::4] & 0xFFFF0000) | 0x8000  # exact ties
    bits[:, 1::4] = (bits[:, 1::4] & 0xFFFF0000) | 0x7FFF
    bits[:, 2::4] = (bits[:, 2::4] & 0xFFFF0000) | 0x8001
    x = bits.view(np.float32).copy()
    x[0, :4] = (0.0, -0.0, 1e-40, 3.0e38)
    return x


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("q,d", [(1, 768), (8, 96), (33, 64)])
def test_float_prep_twin_equals_jax_cast(q, d, bf16):
    """The flat scan's prologue twin: the queries rounded to bf16 bit for
    bit as the JAX package rounds them (``astype(bfloat16)``, round to
    nearest even) for bf16 rows, none for f32 rows, and zeroed merge
    counters; on a CPU tensor the prologue is the twin."""
    x = bf16_halfway_queries(np.random.default_rng(q + d), q, d)
    got = flat_float_prep_plain(torch.from_numpy(x), bf16)
    assert got["merge_count"].dtype == torch.int32
    assert got["merge_count"].tolist() == [0] * q
    if not bf16:
        assert got["qcast"] is None
    else:
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        np.testing.assert_array_equal(
            got["qcast"].view(torch.int16).numpy(), want.view(np.int16))
    again = flat_float_prep(torch.from_numpy(x), bf16)
    assert again.keys() == got.keys()
    for key, value in got.items():
        assert (again[key] is None if value is None
                else torch.equal(again[key], value))


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q", [8, 32])
def test_flat_scan_over_a_capacity_with_a_masked_tail(q, metric):
    """``flat_scan`` as the fused path calls it (the whole capacity, dead
    slots past the count +inf in the penalty) against
    ``pallas_flat_topk_dma`` on the same rows and mask."""
    rng = np.random.default_rng(q)
    cap, count, d, k = 2048, 1100, 128, 10
    v = normed(rng, cap, d)
    v[700] = v[5]  # a planted tie: the lower id first
    mask = np.zeros(cap, dtype=bool)
    mask[:count] = rng.random(count) < 0.8
    mask[[5, 700]] = True
    queries = normed(rng, q, d)
    queries[0] = v[5]
    jv = jnp.asarray(v).astype(jnp.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    kwargs = {}
    if metric == "l2":
        v32 = jv.astype(jnp.float32)
        kwargs = dict(metric="l2", sq_norms=jnp.sum(v32 * v32, axis=1))
    pen, alpha = row_penalty(torch.from_numpy(mask), metric,
                             row_sq_norms(tv))
    ts, ti = flat_scan(("flat", "bfloat16", metric), (tv, None), (pen,),
                       torch.from_numpy(queries), k)
    ps, pi = pallas_flat_topk_dma(jv, jnp.asarray(mask), jnp.asarray(queries),
                                  k, tile_n=1024, interpret=True, **kwargs)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    assert (ti.numpy() < count).all()
    assert ti.numpy()[0, :2].tolist() == [5, 700]
