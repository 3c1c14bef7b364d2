"""The IVF digit scans' prologue and run split, on the CPU.

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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivf_prep_cases import CASES, make_case
from tpu_search.ops.pallas_ivf_scan import build_probe_schedule as jax_schedule
from tpu_search.ops.topk_scan import quantize_queries as jax_quantize
from tpu_search_torch.ops.ivf_scan import (
    IVF_TILE,
    _select,
    digit_block,
    ivf_digit_prep,
    ivf_digit_prep_plain,
)

T = torch.from_numpy
MERGE_BATCH = 16  # csrc/ivf_digit_scan.cuh kMergeBatch


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


def _bits(a):
    return np.asarray(a).view(np.uint32)


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

    tile_idx, clusters, n_sched = jax.jit(jax_schedule, static_argnums=(2, 3))(
        jnp.asarray(probe), jnp.asarray(fills), cap, IVF_TILE)
    n = int(n_sched)
    assert int(got["n_sched"]) == n
    np.testing.assert_array_equal(got["tile_idx"].numpy()[:n],
                                  np.asarray(tile_idx)[:n])
    np.testing.assert_array_equal(got["clusters"].numpy()[:n],
                                  np.asarray(clusters)[:n])
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
    members, counts = got["members"].numpy(), got["member_count"].numpy()
    cl = np.asarray(clusters)[:n]
    for b in range(-(-q // qb)):
        mine = np.zeros(nlist, bool)
        mine[probe[b * qb: (b + 1) * qb].reshape(-1)] = True
        js = np.nonzero(mine[cl])[0]
        assert counts[b] == js.size
        np.testing.assert_array_equal(members[b, : js.size, 1], js)
        np.testing.assert_array_equal(members[b, : js.size, 0],
                                      np.asarray(tile_idx)[js])
        assert not members[b, js.size:].any()


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
