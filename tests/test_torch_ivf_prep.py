"""The ring-fed scans' prologues, run split and merge, on the CPU.

- ``ivf_digit_prep_plain`` (what the prologue kernel writes) against the
  JAX package under ``jax.jit``: ``build_probe_schedule``'s entries below
  ``n_sched`` and ``quantize_queries``'s digits, ``rho`` and ``qs1``, bit
  for bit; the nibble offsets, the bias table and the member lists against
  numpy built from the JAX outputs.  Cases in ``ivf_prep_cases.py``.
- ``run_begin``, a mirror of the scan kernel's run split
  (``csrc/ivf_digit_scan.cuh``, written the same way): runs are
  contiguous, cover ``[0, n)`` exactly and are empty at ``n`` 0, for grids
  larger and smaller than ``n``.
- The merge, modelled step for step (``merge_path_at`` mirrors the
  kernel's co-rank search; batches of 16 runs' lists merged pairwise in a
  tree, then into the running list, ordered by score descending and flat
  slot ascending), equals ``_select`` over the whole schedule on planted
  ties.
- Every scan's group selection, ``warp_merge`` of ``csrc/topk_select.cuh``
  modelled lane for lane (bitonic sort, then each side's rank in the
  other), gives the list that one insertion a candidate gives.
- The bf16 / f32 scan's prologue twin ``ivf_float_prep_plain`` against
  JAX's ``build_probe_schedule`` under ``jax.jit`` and the bf16 cast of
  the queries, bit for bit, with the member lists of its query blocks;
  the scan modelled in Python (each query block's member list split into
  runs, each run's top k over its entries, the runs' lists through the
  merge model) equals ``ivf_topk_plain``.
- The flat int4 scan's prologue twin ``flat_digit_prep_plain`` against
  JAX's ``quantize_queries`` and ``query_nibble_offsets`` under
  ``jax.jit``, bit for bit; the flat scan modelled alike (the corpus's
  128-row tiles split into runs) equals ``flat_topk_int4_plain``.
- The flat int8 scan's prologue twin ``flat_int8_prep_plain`` against
  JAX's ``quantize_queries`` under ``jax.jit``, bit for bit; the scan
  modelled alike, in both corpus layouts, equals ``flat_topk_int8_plain``
  and the JAX ``_int8_call`` in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivf_prep_cases import CASES, make_case
from tpu_search.ops.pallas_ivf_scan import build_probe_schedule as jax_schedule
from tpu_search.ops.topk_scan import quantize_queries as jax_quantize
from tpu_search.ops.topk_scan import query_nibble_offsets as jax_offsets
from tpu_search.ops.pallas_topk_dma import (
    pallas_flat_topk_dma_int8,
    pallas_flat_topk_dma_int8_packed,
)
from tpu_search_torch.index.flat import quantize_rows_int8
from tpu_search_torch.ops.flat_topk_int4 import (
    flat_digit_prep,
    flat_digit_prep_plain,
)
from tpu_search_torch.ops.flat_topk_int8 import (
    flat_int8_prep,
    flat_int8_prep_plain,
)
from tpu_search_torch.ops.int4_pack import (
    nibble_rows_to_bytes,
    quantize_rows_int4,
)
from tpu_search_torch.ops.ivf_scan import (
    FLOAT_CUTOFF,
    IVF_TILE,
    _scores_plain,
    _select,
    float_block,
    ivf_digit_prep,
    ivf_digit_prep_plain,
    ivf_float_prep,
    ivf_float_prep_plain,
    ivf_topk_plain,
)
from tpu_search_torch.ops.ring_scan import digit_block
from tpu_search_torch.ops.int8_pack import pack_int8_rows, unpack_int8_rows
from tpu_search_torch.ops.topk_scan import (
    digit_scores,
    flat_topk_int4_plain,
    flat_topk_int8_plain,
)

T = torch.from_numpy
MERGE_BATCH = 16  # csrc/run_merge.cuh kMergeBatch


def run_begin(n, runs, r):
    """The scan kernel's run_begin: (int)(((long long)n * r) / runs)."""
    return n * r // runs


def ranks_before(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def merge_path_at(a, b, k, i):
    """Output i of the kernel's merge of two sorted lists of k."""
    lo, hi = 0, i
    while True:
        x = (lo + hi) >> 1
        y = i - x
        if x > 0 and y < k and ranks_before(b[y], a[x - 1]):
            hi = x - 1
        elif y > 0 and x < k and not ranks_before(b[y - 1], a[x]):
            lo = x + 1
        else:
            break
    take_a = x < k and (y >= k or not ranks_before(b[y], a[x]))
    return a[x] if take_a else b[y]


def merge_model(lists, k):
    """The kernel's ivf_merge over the runs' lists (each a sorted list of
    k (score, slot) pairs): batches, a pairwise tree, the running list."""
    run = [(float("-inf"), -1)] * k
    for r0 in range(0, len(lists), MERGE_BATCH):
        level = lists[r0: r0 + MERGE_BATCH]
        while len(level) > 1:
            merged = [[merge_path_at(level[2 * p], level[2 * p + 1], k, i)
                       for i in range(k)] for p in range(len(level) // 2)]
            level = merged + level[len(merged) * 2:]
        run = [merge_path_at(run, level[0], k, i) for i in range(k)]
    return run


def warp_merge_model(lst, cands, live):
    """The kernel's warp_merge (``csrc/topk_select.cuh``) lane for lane:
    the 32 candidates (dead ones as (-inf, INT_MAX)) through the bitonic
    network, then each candidate's and each listed entry's place by the
    same binary searches."""
    k = len(lst)
    c = [x if ok else (float("-inf"), 0x7FFFFFFF)
         for x, ok in zip(cands, live)]
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            nxt = list(c)
            for lane in range(32):
                other = c[lane ^ stride]
                best_here = ((lane & size) == 0) == ((lane & stride) == 0)
                if (ranks_before(other, c[lane]) == best_here
                        and other != c[lane]):
                    nxt[lane] = other
            c = nxt
            stride //= 2
        size *= 2
    out = [None] * (k + 32)
    for lane in range(32):
        before, step = 0, 64
        while step:
            if before + step <= k and ranks_before(lst[before + step - 1],
                                                   c[lane]):
                before += step
            step //= 2
        if before < k and ranks_before(lst[before], c[lane]):
            before += 1
        out[lane + before] = c[lane]
    for j in range(k):
        n, step = 0, 16
        while step:
            if ranks_before(c[n + step - 1], lst[j]):
                n += step
            step //= 2
        if n < 32 and ranks_before(c[n], lst[j]):
            n += 1
        out[j + n] = lst[j]
    return out[:k]


@pytest.mark.parametrize("k", [1, 5, 10, 32, 100, 128])
@pytest.mark.parametrize("fill", ["full", "partial", "empty"])
def test_warp_merge_equals_insertion(k, fill):
    """The scans' batch selection (``warp_merge``, where more than three of
    a group of 32 beat the gate) gives the list the one-at-a-time
    insertion gives: the k best of the list and the candidates that beat
    its k-th best, by score descending and id ascending, on planted ties
    between candidates and with the list."""
    rng = np.random.default_rng(k)
    for trial in range(20):
        n_listed = {"full": k, "partial": k // 2, "empty": 0}[fill]
        scores = np.round(rng.standard_normal(n_listed), 1).tolist()
        listed = sorted(zip(scores, rng.choice(1000, n_listed,
                                              replace=False).tolist()),
                        key=lambda e: (-e[0], e[1]))
        lst = listed + [(float("-inf"), -1)] * (k - n_listed)
        cs = np.round(rng.standard_normal(32) + 0.5, 1)
        cs[trial % 32] = lst[0][0]  # a tie with the best listed entry
        cands = list(zip(cs.tolist(), range(1000, 1032)))
        live = [ranks_before(x, lst[-1]) and x[0] > lst[-1][0]
                for x in cands]
        if sum(live) <= 3:
            continue
        want = sorted(lst + [x for x, ok in zip(cands, live) if ok],
                      key=lambda e: (-e[0], e[1]))[:k]
        assert warp_merge_model(lst, cands, live) == want


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _jax_schedule(probe, fills, cap):
    tile_idx, clusters, n_sched = jax.jit(jax_schedule, static_argnums=(2, 3))(
        jnp.asarray(probe), jnp.asarray(fills), cap, IVF_TILE)
    return np.asarray(tile_idx), np.asarray(clusters), int(n_sched)


def _check_members(got, probe, fills, tile_idx, clusters, n, qb):
    """``got``'s member lists: per block of ``qb`` queries, the schedule
    entries (tile, j) of the clusters one of its queries probes."""
    q = probe.shape[0]
    members, counts = got["members"].numpy(), got["member_count"].numpy()
    cl = clusters[:n]
    for b in range(-(-q // qb)):
        mine = np.zeros(fills.shape[0], bool)
        mine[probe[b * qb: (b + 1) * qb].reshape(-1)] = True
        js = np.nonzero(mine[cl])[0]
        assert counts[b] == js.size
        np.testing.assert_array_equal(members[b, : js.size, 1], js)
        np.testing.assert_array_equal(members[b, : js.size, 0], tile_idx[js])
        assert not members[b, js.size:].any()


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_prep_twin_equals_jax(name, int4):
    probe, fills, queries, cbias, cap = make_case(name)
    got = ivf_digit_prep_plain(T(probe), T(fills), T(queries),
                               None if cbias is None else T(cbias), cap, int4)
    q_i8, rho, qs1 = jax.jit(jax_quantize)(jnp.asarray(queries))
    q_i8, rho, qs1 = np.asarray(q_i8), np.asarray(rho), np.asarray(qs1)
    np.testing.assert_array_equal(got["digits"].numpy(), q_i8)
    np.testing.assert_array_equal(_bits(got["rho"].numpy()), _bits(rho))
    np.testing.assert_array_equal(_bits(got["qs1"].numpy()), _bits(qs1))
    if int4:
        want = 8 * q_i8.astype(np.int32).sum(axis=1, dtype=np.int32)
        np.testing.assert_array_equal(got["qoff"].numpy(), want)
    else:
        assert got["qoff"] is None

    tile_idx, clusters, n = _jax_schedule(probe, fills, cap)
    assert int(got["n_sched"]) == n
    np.testing.assert_array_equal(got["tile_idx"].numpy()[:n], tile_idx[:n])
    np.testing.assert_array_equal(got["clusters"].numpy()[:n], clusters[:n])
    assert not got["tile_idx"].numpy()[n:].any()
    if name == "empty_schedule":
        assert n == 0

    q, nprobe = probe.shape
    nlist = fills.shape[0]
    table = np.full((q, nlist), -np.inf, np.float32)
    for qi in range(q):
        bias = (cbias[qi] / qs1[qi] if cbias is not None
                else np.zeros(nprobe, np.float32))
        table[qi, probe[qi]] = bias
    np.testing.assert_array_equal(_bits(got["table"].numpy()), _bits(table))

    qb = digit_block(q)
    assert qb == (8 if q <= 8 else 32)
    _check_members(got, probe, fills, tile_idx, clusters, n, qb)


def test_prep_on_cpu_is_the_twin():
    probe, fills, queries, cbias, cap = make_case("nlist9_q8")
    args = (T(probe), T(fills), T(queries), T(cbias), cap, True)
    got, want = ivf_digit_prep(*args), ivf_digit_prep_plain(*args)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key])


@pytest.mark.parametrize("max_sched", [1, 7, 130, 448])
def test_run_split_covers_the_schedule(max_sched):
    for n in range(max_sched + 1):
        for runs in sorted({1, 2, 3, 7, max(1, n // 3), n or 1, n + 1, 2 * n + 5,
                            264}):
            bounds = [run_begin(n, runs, r) for r in range(runs + 1)]
            assert bounds[0] == 0 and bounds[-1] == n
            assert all(a <= b for a, b in zip(bounds, bounds[1:]))
            sizes = {b - a for a, b in zip(bounds, bounds[1:])}
            assert max(sizes) - min(sizes) <= 1  # balanced
            if n == 0:
                assert sizes == {0}


@pytest.mark.parametrize("runs", [1, 5, 37])
@pytest.mark.parametrize("k", [3, 32, 128])
def test_merge_order_equals_select_on_ties(runs, k):
    rng = np.random.default_rng(runs + k)
    n = 20 * IVF_TILE
    scores = rng.integers(-4, 5, size=(2, n)).astype(np.float32)  # many ties
    scores[:, rng.random(n) < 0.1] = -np.inf
    scores = torch.from_numpy(scores)
    rows = torch.arange(n) * 3 + 11  # ascending flat slots
    want_s, want_i = _select(scores, rows, k)
    for qi in range(2):
        parts = []
        for r in range(runs):
            a, b = run_begin(n, runs, r), run_begin(n, runs, r + 1)
            s, i = _select(scores[qi: qi + 1, a:b], rows[a:b], k)
            parts.append(list(zip(s[0].tolist(), i[0].tolist())))
        got = merge_model(parts, k)
        assert [s for s, _ in got] == want_s[qi].tolist()
        assert [i for _, i in got] == want_i[qi].tolist()


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_float_prep_twin_equals_jax(name, bf16):
    probe, fills, queries, _, cap = make_case(name)
    got = ivf_float_prep_plain(T(probe), T(fills), T(queries), cap, bf16)
    if bf16:
        want = np.asarray(jax.jit(lambda x: x.astype(jnp.bfloat16))(
            jnp.asarray(queries))).view(np.uint16)
        assert got["qcast"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got["qcast"].view(torch.int16).numpy().view(np.uint16), want)
    else:
        assert got["qcast"] is None
    tile_idx, clusters, n = _jax_schedule(probe, fills, cap)
    assert int(got["n_sched"]) == n
    np.testing.assert_array_equal(got["tile_idx"].numpy()[:n], tile_idx[:n])
    np.testing.assert_array_equal(got["clusters"].numpy()[:n], clusters[:n])
    assert not got["clusters"].numpy()[n:].any()
    q = probe.shape[0]
    table = np.full((q, fills.shape[0]), -np.inf, np.float32)
    for qi in range(q):
        table[qi, probe[qi]] = 0.0
    np.testing.assert_array_equal(_bits(got["table"].numpy()), _bits(table))
    qb = float_block(q, bf16)
    assert qb == (32 if bf16 and q > FLOAT_CUTOFF else 16)
    _check_members(got, probe, fills, tile_idx, clusters, n, qb)


def test_float_prep_on_cpu_is_the_twin():
    probe, fills, queries, _, cap = make_case("nlist1024_q33")
    args = (T(probe), T(fills), T(queries), cap, True)
    got, want = ivf_float_prep(*args), ivf_float_prep_plain(*args)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key])


def _model(scores, rows, entries, runs, k):
    """One query's scan modelled: its block's ``entries`` (schedule
    positions) split into ``runs`` contiguous runs, each run's top k over
    its entries' 128 rows (``_select``: the kernel's sorted list behind a
    strict gate), the runs' lists through ``merge_model``."""
    lists = []
    for r in range(runs):
        a = run_begin(len(entries), runs, r)
        b = run_begin(len(entries), runs, r + 1)
        cols = (np.asarray(entries[a:b], dtype=np.int64)[:, None] * IVF_TILE
                + np.arange(IVF_TILE)[None, :]).reshape(-1)
        s, i = _select(scores[None, cols], rows[cols], k)
        lists.append(list(zip(s[0].tolist(), i[0].tolist())))
    return merge_model(lists, k)


def _ivf_float_state(seed, nlist=12, cap=256, d=32, q=20):
    rng = np.random.default_rng(seed)
    fills = rng.integers(0, cap + 1, size=nlist).astype(np.int32)
    fills[3] = 0
    blocks = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    blocks[0, 9] = blocks[0, 4]  # an exact tie
    live = np.arange(cap)[None, :] < fills[:, None]
    live &= rng.random((nlist, cap)) > 0.2
    live[0, [4, 9]] = True
    fills[0] = max(fills[0], 10)
    pen = np.where(live, 0.0, np.inf).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[0] = blocks[0, 4]
    return blocks, pen, fills, queries, rng


@pytest.mark.parametrize("q,nprobe", [(1, 4), (16, 3), (20, 5), (70, 2)])
@pytest.mark.parametrize("runs", [1, 3, 40])
@pytest.mark.parametrize("k", [5, 64])
def test_float_scan_model_equals_plain(q, nprobe, runs, k):
    blocks, pen, fills, queries, rng = _ivf_float_state(q + runs, q=q)
    nlist, cap, _ = blocks.shape
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(q)])
    probe[0] = np.r_[0, rng.permutation(np.arange(1, nlist))[: nprobe - 1]]
    probe = T(probe.astype(np.int32))
    b, p, f, qs = T(blocks), T(pen), T(fills), T(queries)
    prep = ivf_float_prep_plain(probe, f, qs, cap, bf16=False)
    flat = b.reshape(-1, b.shape[2])

    def score_rows(r):
        return qs @ flat[r].T

    scores, rows = _scores_plain(score_rows, p, f, probe, cap)
    want_s, want_i = ivf_topk_plain(b, p, f, probe, qs, k)
    qb = float_block(q, False)
    for qi in range(q):
        blk = qi // qb
        n = int(prep["member_count"][blk])
        entries = prep["members"][blk, :n, 1].tolist()
        got = _model(scores[qi], rows, entries, runs, k)
        assert [s for s, _ in got] == want_s[qi].tolist()
        assert [i for _, i in got] == want_i[qi].tolist()
    if k > 1:
        assert want_i[0, :2].tolist() == [4, 9]


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_prep_twin_equals_jax(name):
    queries = make_case(name)[2]
    got = flat_digit_prep_plain(T(queries))
    q_i8, rho, qs1 = jax.jit(jax_quantize)(jnp.asarray(queries))
    qoff = jax.jit(jax_offsets)(q_i8)
    np.testing.assert_array_equal(got["digits"].numpy(), np.asarray(q_i8))
    np.testing.assert_array_equal(_bits(got["rho"].numpy()), _bits(rho))
    np.testing.assert_array_equal(_bits(got["qs1"].numpy()), _bits(qs1))
    np.testing.assert_array_equal(got["qoff"].numpy(), np.asarray(qoff))
    assert got["qoff"].dtype == torch.int32


def test_flat_prep_on_cpu_is_the_twin():
    queries = T(make_case("nlist9_q33_all_probed")[2])
    got, want = flat_digit_prep(queries), flat_digit_prep_plain(queries)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key])


def _flat_model(scores, rows, tiles, runs, k, split):
    """One query's flat scan modelled over the padded ``scores`` of
    ``tiles`` 128-row tiles: balanced runs of tiles (the ring) or ranges
    of a fixed number of tiles (digit_partial; the last one short), then
    the merge."""
    if split == "runs":
        return _model(scores, rows, list(range(tiles)), min(runs, tiles), k)
    per = -(-tiles // runs)  # tiles a range
    return merge_model([_model(scores, rows,
                               list(range(t0, min(tiles, t0 + per))), 1, k)
                        for t0 in range(0, tiles, per)], k)


@pytest.mark.parametrize("n,q,runs", [(1000, 1, 1), (1000, 3, 4),
                                      (4133, 9, 33), (300, 2, 7)])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("split", ["runs", "ranges"])
def test_flat_scan_model_equals_plain(n, q, runs, k, split):
    """The flat int4 scan modelled: every 128-row tile an entry (rows past
    n -inf), split into balanced runs (the ring, Q > 8) or ranges of a
    fixed number of tiles (digit_partial, Q <= 8), then the merge; times
    qs1 after it."""
    rng = np.random.default_rng(n + q + runs)
    v = rng.standard_normal((n, 64)).astype(np.float32)
    v[7 % n] = v[3 % n]
    u, scales = quantize_rows_int4(T(v))
    nib = nibble_rows_to_bytes(u)
    live = rng.random(n) > 0.1
    live[[3 % n, 7 % n]] = True
    pen = T(np.where(live, 0.0, -np.inf).astype(np.float32))
    queries = rng.standard_normal((q, 64)).astype(np.float32)
    queries[0] = v[3 % n]
    prep = flat_digit_prep_plain(T(queries))
    dots = (prep["digits"].double() @ u[:n].double().T
            - prep["qoff"].double()[:, None])
    scores = digit_scores(dots, prep["rho"], scales, pen)
    tiles = -(-n // IVF_TILE)
    padded = torch.full((q, tiles * IVF_TILE), float("-inf"))
    padded[:, :n] = scores
    rows = torch.arange(tiles * IVF_TILE)
    want_s, want_i = flat_topk_int4_plain(nib, scales, pen, T(queries), k)
    for qi in range(q):
        got = _flat_model(padded[qi], rows, tiles, runs, k, split)
        got_s = torch.tensor([s for s, _ in got]) * prep["qs1"][qi]
        assert got_s.tolist() == want_s[qi].tolist()
        assert [i for _, i in got] == want_i[qi].tolist()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_int8_prep_twin_equals_jax(name):
    """The int8 flat scan's prologue twin (no nibble offsets) against
    jitted JAX ``quantize_queries``, bit for bit."""
    queries = make_case(name)[2]
    got = flat_int8_prep_plain(T(queries))
    q_i8, rho, qs1 = jax.jit(jax_quantize)(jnp.asarray(queries))
    assert got.keys() == {"digits", "rho", "qs1"}
    np.testing.assert_array_equal(got["digits"].numpy(), np.asarray(q_i8))
    np.testing.assert_array_equal(_bits(got["rho"].numpy()), _bits(rho))
    np.testing.assert_array_equal(_bits(got["qs1"].numpy()), _bits(qs1))


def test_flat_int8_prep_on_cpu_is_the_twin():
    queries = T(make_case("nlist9_q33_all_probed")[2])
    got, want = flat_int8_prep(queries), flat_int8_prep_plain(queries)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key])


_JAX_TILE = 256


def _jax_int8(corpus, scales, live, queries, k, words):
    """The JAX ``_int8_call`` (through its two entry points) in interpret
    mode, the corpus padded with masked rows to whole tiles."""
    n = live.shape[0]
    pad = -(-n // _JAX_TILE) * _JAX_TILE - n
    fn = (pallas_flat_topk_dma_int8_packed if words
          else pallas_flat_topk_dma_int8)
    corpus = np.pad(corpus, ((0, pad // 4 if words else pad), (0, 0)))
    s, i = fn(jnp.asarray(corpus), jnp.asarray(np.pad(scales, (0, pad))),
              jnp.asarray(np.pad(live, (0, pad))), jnp.asarray(queries), k,
              tile_n=_JAX_TILE, interpret=True)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("words", [False, True])
@pytest.mark.parametrize("n,q,runs", [(1000, 1, 1), (1000, 3, 4),
                                      (4133, 9, 33), (300, 2, 7)])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_flat_int8_scan_model_equals_plain(n, q, runs, k, words):
    """The flat int8 scan modelled (the prologue twin's digits, exact
    dots, every 128-row tile an entry, rows past n -inf) in runs of tiles
    (the ring) and in row ranges (digit_partial), then the merge, then
    times qs1: equal to ``flat_topk_int8_plain`` and to the JAX
    ``_int8_call`` in interpret mode, in the row layout and (through
    ``unpack_int8_rows``) the word layout, with a planted tie."""
    if words:
        n -= n % 4  # the word layout holds whole words
    rng = np.random.default_rng(n + q + runs)
    v = rng.standard_normal((n, 64)).astype(np.float32)
    v[7 % n] = v[3 % n]
    i8, scales = quantize_rows_int8(T(v))
    corpus = pack_int8_rows(i8) if words else i8
    rows = unpack_int8_rows(corpus) if words else corpus
    live = rng.random(n) > 0.1
    live[[3 % n, 7 % n]] = True
    pen = T(np.where(live, 0.0, -np.inf).astype(np.float32))
    queries = rng.standard_normal((q, 64)).astype(np.float32)
    queries[0] = v[3 % n]
    prep = flat_int8_prep_plain(T(queries))
    scores = digit_scores(prep["digits"].double() @ rows.double().T,
                          prep["rho"], scales, pen)
    tiles = -(-n // IVF_TILE)
    padded = torch.full((q, tiles * IVF_TILE), float("-inf"))
    padded[:, :n] = scores
    ids = torch.arange(tiles * IVF_TILE)
    want_s, want_i = flat_topk_int8_plain(i8, scales, pen, T(queries), k)
    jax_s, jax_i = _jax_int8(corpus.numpy(), scales.numpy(), live, queries,
                             k, words)
    np.testing.assert_array_equal(jax_i, want_i.numpy())
    np.testing.assert_array_equal(_bits(jax_s), _bits(want_s.numpy()))
    for qi in range(q):
        for split in ("runs", "ranges"):
            got = _flat_model(padded[qi], ids, tiles, runs, k, split)
            got_s = torch.tensor([s for s, _ in got]) * prep["qs1"][qi]
            assert got_s.tolist() == want_s[qi].tolist()
            assert [i for _, i in got] == want_i[qi].tolist()
    if k > 1:
        assert want_i[0, :2].tolist() == [3 % n, 7 % n]
