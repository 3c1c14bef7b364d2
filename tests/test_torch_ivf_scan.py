"""The port's IVF probe schedule and plain probe scans against
``tpu_search.ops.pallas_ivf_scan`` (Pallas kernels in interpret mode on the
CPU) and the JAX package's XLA grouped path.

Tolerances:
- ``build_probe_schedule``: equal arrays and ``n_sched``;
- int8 / int4 scans: scores and ids bit-identical to
  ``pallas_ivf_topk_int8`` / ``_int4`` (the combine is one FMA, then
  ``* scale``, ``+ penalty`` and ``+ cbias / qs1`` each one f32 rounding,
  as measured against the interpret-mode kernels);
- bf16 / f32 scans: ids equal, scores within 1e-5 (bf16) / 1e-6 (f32),
  f32 sums of the same products in another order;
- k > 128 (the kernels' scores-only mode; the JAX package answers it with
  ``_ivf_search``, which adds the residual term as ``cluster_score *
  (1 / qs1)``): ids equal outside near-ties, scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.index.ivf import _ivf_search
from tpu_search.ops.pallas_ivf_scan import (
    build_probe_schedule as jax_schedule,
    pallas_ivf_topk,
    pallas_ivf_topk_int4,
    pallas_ivf_topk_int8,
)
from tpu_search_torch.ops.ivf_scan import (
    build_probe_schedule,
    ivf_topk_int4_plain,
    ivf_topk_int4_scan,
    ivf_topk_int8_plain,
    ivf_topk_int8_scan,
    ivf_topk_plain,
    ivf_topk_scan,
    probe_positions,
)

T = torch.from_numpy


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def make_state(rng, nlist=6, cap=256, d=64, tomb_frac=0.2):
    """Ragged fills, tombstones, an empty cluster, rows near centroids."""
    fills = rng.integers(cap // 4, cap + 1, size=nlist).astype(np.int32)
    fills[1] = 0
    centroids = normed(rng, nlist, d)
    blocks = np.zeros((nlist, cap, d), np.float32)
    valid = np.zeros((nlist, cap), bool)
    ids = np.full((nlist, cap), -1, np.int32)
    gid = 0
    for c in range(nlist):
        rows = centroids[c] + 0.3 * rng.standard_normal((fills[c], d))
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        blocks[c, : fills[c]] = rows
        valid[c, : fills[c]] = rng.random(fills[c]) > tomb_frac
        ids[c, : fills[c]] = np.arange(gid, gid + fills[c])
        gid += fills[c]
    return centroids, blocks, ids, valid, fills


def quantize(blocks, centroids, residual, levels):
    """Per-slot symmetric codes of the index (int8: levels 127, int4: 7)."""
    target = blocks - centroids[:, None, :] if residual else blocks
    scales = np.maximum(np.abs(target).max(-1) * np.float32(1 / levels),
                        np.float32(1e-12)).astype(np.float32)
    codes = np.rint(target / scales[..., None])
    return np.clip(codes, -levels, levels), scales


def int4_layouts(codes):
    """Biased nibbles -> (the JAX [nlist, cap/8, D] int32 words, the port's
    [nlist, cap/2, D] nibble-pair bytes)."""
    u = (codes + 8).astype(np.int64)
    w = np.zeros((u.shape[0], u.shape[1] // 8, u.shape[2]), np.int64)
    for j in range(8):
        w |= u[:, j::8, :] << (4 * j)
    words = w.astype(np.uint32).view(np.int32)
    return words, (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)


def probes(queries, centroids, nprobe):
    cs = queries @ centroids.T
    probe = np.argsort(-cs, axis=1, kind="stable")[:, :nprobe].astype(np.int32)
    return cs, probe, np.take_along_axis(cs, probe, 1).astype(np.float32)


@pytest.mark.parametrize("case", ["covers", "empty", "random"])
@pytest.mark.parametrize("tile", [128, 256])
def test_schedule_equals_jax(case, tile):
    rng = np.random.default_rng(3)
    if case == "covers":  # tests/test_pallas_ivf_scan.py's first case
        nlist, cap = 8, 512
        fills = rng.integers(0, cap + 1, size=nlist).astype(np.int32)
        probe = rng.integers(0, nlist, size=(4, 3)).astype(np.int32)
    elif case == "empty":
        nlist, cap = 4, 256
        fills = np.zeros((4,), np.int32)
        probe = np.asarray([[0, 1], [2, 3]], np.int32)
    else:
        nlist, cap = 40, 1024
        fills = rng.integers(0, cap + 1, size=nlist).astype(np.int32)
        fills[::5] = 0
        probe = rng.integers(0, nlist, size=(9, 6)).astype(np.int32)
    want = [np.asarray(a) for a in jax_schedule(
        jnp.asarray(probe), jnp.asarray(fills), cap, tile)]
    got = [t.numpy() for t in build_probe_schedule(
        T(probe), T(fills), cap, tile)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    if case == "empty":
        assert int(got[2]) == 0


def test_probe_positions():
    probe = T(np.asarray([[2, 0], [1, 3]], np.int32))
    pos = probe_positions(probe, 4).numpy()
    np.testing.assert_array_equal(pos, [[1, -1, 0, -1], [-1, 0, -1, 1]])


def _jax_ids(ps, pos, ids):
    return np.where(np.isfinite(ps), ids.reshape(-1)[np.clip(pos, 0, None)], -1)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,nprobe,k,tomb", [(8, 3, 10, 0.2), (1, 1, 50, 0.9)])
def test_float_scan_matches_pallas(metric, dtype, q, nprobe, k, tomb):
    rng = np.random.default_rng(0)
    cent, blocks, ids, valid, fills = make_state(rng, tomb_frac=tomb)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jb = jnp.asarray(blocks).astype(jdt)
    sq = np.asarray(jnp.sum(jb.astype(jnp.float32) ** 2, axis=-1))
    pen = np.where(valid, sq if metric == "l2" else 0.0, np.inf).astype(
        np.float32)
    queries = normed(rng, q, blocks.shape[2])
    _, probe, _ = probes(queries, cent, nprobe)
    js, jpos = pallas_ivf_topk(jb, jnp.asarray(pen), jnp.asarray(fills),
                               jnp.asarray(probe), jnp.asarray(queries), k,
                               tile_n=128, interpret=True, metric=metric)
    js, jpos = np.asarray(js), np.asarray(jpos)
    alpha = 2.0 if metric == "l2" else 1.0
    args = (T(blocks).to(tdt), T(pen), T(fills), T(probe), T(queries), k,
            alpha)
    for fn in (ivf_topk_plain, ivf_topk_scan):
        ts, tpos = fn(*args)
        fin = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
        np.testing.assert_array_equal(tpos.numpy(), np.where(fin, jpos, -1))
        np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=0,
                                   atol=1e-5 if dtype == "bfloat16" else 1e-6)


def quant_case(kind, residual, seed=2, q=8, nprobe=3):
    rng = np.random.default_rng(seed)
    cent, blocks, ids, valid, fills = make_state(rng)
    levels = 127 if kind == "int8" else 7
    codes, scales = quantize(blocks, cent, residual, levels)
    pen = np.where(valid, 0.0, -np.inf).astype(np.float32)
    queries = normed(rng, q, blocks.shape[2])
    _, probe, cb = probes(queries, cent, nprobe)
    return cent, codes, scales, pen, ids, valid, fills, queries, probe, (
        cb if residual else None)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [10, 128])
def test_quant_scan_bit_identical_to_pallas(kind, residual, k):
    (_, codes, scales, pen, _, _, fills, queries, probe,
     cb) = quant_case(kind, residual)
    jcb = None if cb is None else jnp.asarray(cb)
    if kind == "int8":
        jblocks = jnp.asarray(codes.astype(np.int8))
        mine = T(codes.astype(np.int8))
        jfn, plain, scan = pallas_ivf_topk_int8, ivf_topk_int8_plain, (
            ivf_topk_int8_scan)
    else:
        words, nib = int4_layouts(codes)
        jblocks, mine = jnp.asarray(words), T(nib)
        jfn, plain, scan = pallas_ivf_topk_int4, ivf_topk_int4_plain, (
            ivf_topk_int4_scan)
    js, jpos = jfn(jblocks, jnp.asarray(scales), jnp.asarray(pen),
                   jnp.asarray(fills), jnp.asarray(probe),
                   jnp.asarray(queries), k, tile_n=128, interpret=True,
                   cbias=jcb)
    js, jpos = np.asarray(js), np.asarray(jpos)
    want_pos = np.where(np.isfinite(js), jpos, -1)
    for fn in (plain, scan):
        ts, tpos = fn(mine, T(scales), T(pen), T(fills), T(probe),
                      T(queries), k, cbias=None if cb is None else T(cb))
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(tpos.numpy(), want_pos)


@pytest.mark.parametrize("kind", ["bfloat16", "int8", "int4"])
def test_k_above_128_matches_xla_grouped_path(kind):
    """The scores-only mode's contract (all scheduled rows, stable sort)
    against ``_ivf_search``, which the JAX package runs for k > 128."""
    k, nprobe = 200, 3
    (cent, codes, scales, pen, ids, valid, fills, queries, probe,
     cb) = quant_case("int8" if kind == "bfloat16" else kind, True, seed=7)
    dvalid = jnp.asarray(valid)
    if kind == "bfloat16":
        rng = np.random.default_rng(7)
        _, blocks, ids, valid, fills = make_state(rng)
        dvalid = jnp.asarray(valid)
        jb = jnp.asarray(blocks).astype(jnp.bfloat16)
        rs, ri = _ivf_search(jnp.asarray(cent), jb, jnp.asarray(ids), dvalid,
                             jnp.zeros(valid.shape), jnp.ones(valid.shape),
                             jnp.asarray(queries), nprobe, k, "ip")
        pen = np.where(valid, 0.0, np.inf).astype(np.float32)
        ts, tpos = ivf_topk_scan(T(blocks).to(torch.bfloat16), T(pen),
                                 T(fills), T(probe), T(queries), k)
    else:
        if kind == "int8":
            jb, mine, fn = jnp.asarray(codes.astype(np.int8)), T(
                codes.astype(np.int8)), ivf_topk_int8_scan
        else:
            words, nib = int4_layouts(codes)
            jb, mine, fn = jnp.asarray(words), T(nib), ivf_topk_int4_scan
        rs, ri = _ivf_search(jnp.asarray(cent), jb, jnp.asarray(ids), dvalid,
                             jnp.zeros(valid.shape), jnp.asarray(scales),
                             jnp.asarray(queries), nprobe, k, "ip",
                             by_residual=True)
        ts, tpos = fn(mine, T(scales), T(pen), T(fills), T(probe),
                      T(queries), k, cbias=T(cb))
    rs, ri = np.asarray(rs), np.asarray(ri)
    ts = ts.numpy()
    got = np.where(tpos.numpy() >= 0,
                   ids.reshape(-1)[np.clip(tpos.numpy(), 0, None)], -1)
    fin = np.isfinite(rs)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_allclose(ts[fin], rs[fin], rtol=0, atol=1e-4)
    assert ((got == ri) | (np.abs(ts - rs) <= 1e-4) | ~fin).all()
    assert (got[~fin] == -1).all()
