"""The port's int8 / int4 query quantizer, packing helpers and plain scans
against the JAX package's.

Tolerances: the quantizers, the pack helpers and the plain scans against
the jitted XLA ``flat_topk_int8`` / ``flat_topk_int4`` are bit-identical
(scores and ids equal).  Under jit XLA divides by 127 as a multiply by the
f32 reciprocal and fuses the query residual and the digit combine into
FMAs; the port writes each of those out.  Against the Pallas kernels in
interpret mode: ids equal, scores within 1e-5, as
``tests/test_pallas_topk_dma.py`` holds them against XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.ops import int4_pack as jint4
from tpu_search.ops import int8_pack as jint8
from tpu_search.ops.pallas_topk_dma import (
    pallas_flat_topk_dma_int4,
    pallas_flat_topk_dma_int8,
    pallas_flat_topk_dma_int8_packed,
)
from tpu_search.ops.topk_scan import flat_topk_int4, flat_topk_int8
from tpu_search.ops.topk_scan import quantize_queries as jax_quantize_queries
from tpu_search.ops.topk_scan import (
    query_nibble_offsets as jax_query_nibble_offsets,
)
from tpu_search_torch.ops import int4_pack, int8_pack
from tpu_search_torch.ops.flat_topk_int4 import flat_topk_int4_scan
from tpu_search_torch.ops.flat_topk_int8 import flat_topk_int8_scan
from tpu_search_torch.ops.topk_scan import (
    flat_topk_int4_plain,
    flat_topk_int8_plain,
    quantize_queries,
    query_nibble_offsets,
)

TOL = 1e-5
T = torch.from_numpy


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def int8_corpus(rng, n, d):
    v = normed(rng, n, d)
    scales = np.maximum(
        np.abs(v).max(axis=1).astype(np.float32) * np.float32(1.0 / 127.0),
        np.float32(1e-12))
    return np.rint(v / scales[:, None]).astype(np.int8), scales, v


def penalty_of(mask):
    return T(np.where(mask, 0.0, -np.inf).astype(np.float32))


@pytest.mark.parametrize("d", [128, 768])
def test_quantize_queries_bit_identical_to_jit(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2000, d)).astype(np.float32)
    x[0] = 0.0  # the 1e-12 floor
    amax = np.abs(x).max(axis=1)
    # rows where the true quotient and the reciprocal multiply differ
    assert (amax / np.float32(127.0) != amax * np.float32(1.0 / 127.0)).sum() > 20
    want = [np.asarray(a) for a in jax.jit(jax_quantize_queries)(jnp.asarray(x))]
    got = [t.numpy() for t in quantize_queries(T(x))]
    for name, a, b in zip(("q_i8", "rho", "qs1"), want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(
        query_nibble_offsets(T(want[0])).numpy(),
        np.asarray(jax_query_nibble_offsets(jnp.asarray(want[0]))))


@pytest.mark.parametrize("n,d,q,k", [(4096, 128, 8, 10), (2048, 128, 5, 128),
                                     (8192, 768, 16, 10), (3000, 64, 3, 200)])
def test_int8_plain_bit_identical_to_xla(n, d, q, k):
    rng = np.random.default_rng(n + q)
    rows, scales, _ = int8_corpus(rng, n, d)
    rows[11] = rows[4]  # an exact tie
    scales[11] = scales[4]
    mask = rng.random(n) < 0.7
    mask[[4, 11]] = True
    queries = normed(rng, q, d)
    queries[0] = rows[4] * scales[4]
    xs, xi = flat_topk_int8(jnp.asarray(rows), jnp.asarray(scales),
                            jnp.asarray(mask), jnp.asarray(queries), k)
    ps, pi = flat_topk_int8_plain(T(rows), T(scales), penalty_of(mask),
                                  T(queries), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(xs))
    assert pi[0, :2].tolist() == [4, 11]


@pytest.mark.parametrize("n,d,q,k", [(4096, 128, 8, 10), (2048, 128, 5, 128),
                                     (8192, 768, 16, 10), (3000, 64, 3, 200)])
def test_int4_plain_bit_identical_to_xla(n, d, q, k):
    rng = np.random.default_rng(n + 2 * q)
    v = normed(rng, n + (-n) % 8, d)
    v[13] = v[6]
    u, scales = jint4.quantize_rows_int4_host(v)
    mask = rng.random(v.shape[0]) < 0.7
    mask[n:] = False  # rows padding the JAX words are dead
    mask[[6, 13]] = True
    queries = normed(rng, q, d)
    queries[0] = v[6]
    xs, xi = flat_topk_int4(jnp.asarray(jint4.pack_int4_rows_host(u)),
                            jnp.asarray(scales), jnp.asarray(mask),
                            jnp.asarray(queries), k)
    nib = T(int4_pack.nibble_rows_to_disk_bytes(u[:n]))
    ps, pi = flat_topk_int4_plain(nib, T(scales[:n]), penalty_of(mask[:n]),
                                  T(queries), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(xs))
    assert pi[0, :2].tolist() == [6, 13]


@pytest.mark.parametrize("k", [10, 128])
def test_int8_plain_matches_pallas_interpret(k):
    rng = np.random.default_rng(4)
    n, d, q = 4096, 128, 8
    rows, scales, _ = int8_corpus(rng, n, d)
    mask = rng.random(n) < 0.6
    queries = normed(rng, q, d)
    args = (jnp.asarray(scales), jnp.asarray(mask), jnp.asarray(queries), k)
    ps, pi = flat_topk_int8_plain(T(rows), T(scales), penalty_of(mask),
                                  T(queries), k)
    for fn, corpus in (
        (pallas_flat_topk_dma_int8, rows),
        (pallas_flat_topk_dma_int8_packed, jint8.pack_int8_rows_host(rows)),
    ):
        ks, ki = fn(jnp.asarray(corpus), *args, tile_n=1024, interpret=True)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ki))
        np.testing.assert_allclose(ps.numpy(), np.asarray(ks), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("k", [10, 128])
def test_int4_plain_matches_pallas_interpret(k):
    rng = np.random.default_rng(10)
    n, d, q = 4096, 128, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    u, scales = jint4.quantize_rows_int4_host(v)
    mask = rng.random(n) < 0.6
    queries = normed(rng, q, d)
    ks, ki = pallas_flat_topk_dma_int4(
        jnp.asarray(jint4.pack_int4_rows_host(u)), jnp.asarray(scales),
        jnp.asarray(mask), jnp.asarray(queries), k, tile_n=1024,
        interpret=True)
    ps, pi = flat_topk_int4_plain(
        T(int4_pack.nibble_rows_to_disk_bytes(u)), T(scales),
        penalty_of(mask), T(queries), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ki))
    np.testing.assert_allclose(ps.numpy(), np.asarray(ks), rtol=TOL, atol=TOL)


def test_all_masked_rows_give_minus_one():
    rng = np.random.default_rng(5)
    n, d = 1024, 64
    rows, scales, v = int8_corpus(rng, n, d)
    mask = np.zeros(n, dtype=bool)
    mask[[9, 500]] = True
    queries = T(normed(rng, 3, d))
    u, s4 = int4_pack.quantize_rows_int4(T(v))
    for s, i in (
        flat_topk_int8_plain(T(rows), T(scales), penalty_of(mask), queries, 6),
        flat_topk_int4_plain(int4_pack.nibble_rows_to_bytes(u), s4,
                             penalty_of(mask), queries, 6),
    ):
        assert sorted(i[0, :2].tolist()) == [9, 500]
        assert (i[:, 2:] == -1).all() and torch.isneginf(s[:, 2:]).all()


def test_int8_pack_helpers_match_jax():
    rng = np.random.default_rng(6)
    rows = rng.integers(-127, 128, size=(64, 96)).astype(np.int8)
    words = jint8.pack_int8_rows_host(rows)
    np.testing.assert_array_equal(int8_pack.pack_int8_rows_host(rows), words)
    np.testing.assert_array_equal(
        np.asarray(jint8.pack_int8_rows(jnp.asarray(rows))), words)
    np.testing.assert_array_equal(int8_pack.pack_int8_rows(T(rows)).numpy(),
                                  words)
    np.testing.assert_array_equal(int8_pack.unpack_int8_rows_host(words), rows)
    np.testing.assert_array_equal(
        int8_pack.unpack_int8_rows(T(words)).numpy(),
        np.asarray(jint8.unpack_int8_rows(jnp.asarray(words))))


@pytest.mark.parametrize("n", [64, 37])
def test_int4_pack_helpers_match_jax(n):
    rng = np.random.default_rng(n)
    v = rng.standard_normal((n, 96)).astype(np.float32) * rng.uniform(
        0.01, 3.0, size=(n, 1)).astype(np.float32)
    v[0] = 0.0
    u, s = jint4.quantize_rows_int4_host(v)
    ju, js = jax.jit(jint4.quantize_rows_int4)(jnp.asarray(v))
    for pu, ps in (int4_pack.quantize_rows_int4_host(v),
                   [t.numpy() for t in int4_pack.quantize_rows_int4(T(v))]):
        np.testing.assert_array_equal(pu, u)
        np.testing.assert_array_equal(pu, np.asarray(ju).astype(np.uint8))
        np.testing.assert_array_equal(ps, s)
        np.testing.assert_array_equal(ps, np.asarray(js))
    disk = jint4.nibble_rows_to_disk_bytes(u)
    np.testing.assert_array_equal(int4_pack.nibble_rows_to_disk_bytes(u), disk)
    np.testing.assert_array_equal(
        int4_pack.nibble_rows_to_bytes(T(u)).numpy(), disk)
    np.testing.assert_array_equal(
        int4_pack.bytes_to_nibble_rows(T(disk)).numpy()[:n], u)
    if n % 8 == 0:
        words = jint4.pack_int4_rows_host(u)
        np.testing.assert_array_equal(int4_pack.bytes_to_words_host(disk),
                                      words)
        np.testing.assert_array_equal(int4_pack.words_to_bytes_host(words),
                                      disk)
        np.testing.assert_array_equal(jint4.words_to_bytes_host(words), disk)
    assert int4_pack.NIBBLE_BIAS == jint4.NIBBLE_BIAS


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    rng = np.random.default_rng(7)
    n, d = 512, 64
    rows, scales, v = int8_corpus(rng, n, d)
    mask = rng.random(n) < 0.8
    queries = T(normed(rng, 4, d))
    pen = penalty_of(mask)
    want = flat_topk_int8_plain(T(rows), T(scales), pen, queries, 7)
    for got in (
        flat_topk_int8_scan(T(rows), T(scales), pen, queries, 7),
        flat_topk_int8_scan(int8_pack.pack_int8_rows(T(rows)), T(scales), pen,
                            queries, 7, words=True),
    ):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    u, s4 = int4_pack.quantize_rows_int4(T(v))
    nib = int4_pack.nibble_rows_to_bytes(u)
    got = flat_topk_int4_scan(nib, s4, pen, queries, 7)
    want = flat_topk_int4_plain(nib, s4, pen, queries, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    meta = torch.zeros((n, d), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flat_topk_int8_scan(meta, T(scales), pen, queries, 7)
    with pytest.raises(ValueError, match="unsupported device"):
        flat_topk_int4_scan(meta.to(torch.uint8), T(scales), pen, queries, 7)
