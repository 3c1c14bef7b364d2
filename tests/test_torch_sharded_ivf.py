"""The port's ``ShardedIVFIndex`` against ``tpu_search``'s on the CPU, each
over 8 shards (the JAX index on its 8 virtual CPU devices, the port's on
the host counted 8 times).

The JAX index is built first (its ``jax.random`` k-means cannot be
reproduced from a seed); the port index starts from its centroids (and pq
books, OPQ rotation) and takes the same adds, removes, growth past the
first local capacity, ``compact`` and ``rebalance`` (the JAX k-means
randomness handed over), in each of: f32 and bf16 (ip and l2), int8, int4,
pq, pq with OPQ, int4 with the int8 refine tier and int8 with the bf16
one.  Both packages' ``_SLOT_ALIGN`` is 128 here (the port's probe scans
take 128-slot tiles), so that a few thousand rows grow the layout.

- Layout: the local capacity, the ``[nlist, S]`` fills, the id and
  validity planes (host and device) slot for slot; the stored values of
  every live slot (rows, int8 codes, int4 / pq nibbles) and the scales
  equal, bit for bit (after a rebalance of residual rows, re-encoded
  against centroids that agree within 1e-5: codes within one step, scales
  within 1e-4); the refine rows, shard by shard.
- Stage 1 (the coarse probe scan and merge): each JAX shard's slice
  through the Pallas kernel the JAX package deploys
  (``pallas_ivf_topk*`` in interpret mode, on the port's probes), then
  ``lax.top_k`` over the shard-major concatenation, against the port's
  ``sharded_ivf_scan``: int8 / int4 scores and ids equal, bit for bit;
  bf16 / f32 ids equal, scores within 1e-5 relative.
- ``search`` against the JAX index's (its CPU path, the XLA scan; pq the
  XLA ADC): ids equal outside near-ties, scores within 1e-5 (pq:
  ``tests/test_torch_ivf_pq.py``'s 1e-5), int8 / int4 within 1e-4 (as
  ``tests/test_torch_ivf_index.py``: the XLA scan sums in another order).

Here the float cases; ``tests/test_torch_sharded_ivf_quant.py`` runs the
same test on the quantized ones, and ``tests/test_torch_sharded_ivf_files.py``
holds the two packages' files and the merge's tie rule to each other.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_ivf_index import jax_train_randomness
from tpu_search.ops.pallas_ivf_scan import (
    pallas_ivf_topk,
    pallas_ivf_topk_int4,
    pallas_ivf_topk_int8,
)
from tpu_search.parallel import ShardedIVFIndex as JaxSharded
from tpu_search.parallel import build_mesh as jax_build_mesh
from tpu_search_torch.index.ivf import probe_clusters
from tpu_search_torch.parallel import ShardedIVFIndex, build_mesh
from tpu_search_torch.parallel.sharded_ivf import sharded_ivf_scan

D, NLIST, S, ALIGN = 32, 8, 8, 128
CASES = {
    "f32": dict(dtype="float32"),
    "f32_l2": dict(dtype="float32", metric="l2"),
    "bf16": dict(dtype="bfloat16"),
    "bf16_l2": dict(dtype="bfloat16", metric="l2"),
    "int8": dict(dtype="int8"),
    "int4": dict(dtype="int4"),
    "pq": dict(dtype="pq", pq_m=8),
    "pq_opq": dict(dtype="pq", pq_m=8, opq=True),
    "int4_refine": dict(dtype="int4", refine_dtype="int8", refine_factor=4),
    "int8_refine": dict(dtype="int8", refine_dtype="bfloat16"),
}
NIBBLE = ("int4", "pq")


def clustered(seed, n, d=D, centers=12):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + 0.4 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _env():
    """The port on the CPU; both packages at ``_SLOT_ALIGN`` 128."""
    import tpu_search.parallel.sharded_ivf as jmod
    import tpu_search_torch.parallel.sharded_ivf as tmod

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        mp.setattr(jmod, "_SLOT_ALIGN", ALIGN)
        mp.setattr(tmod, "_SLOT_ALIGN", ALIGN)
        yield


@pytest.fixture(scope="module")
def meshes():
    return (jax_build_mesh(n_data=S),
            build_mesh(n_data=S, devices=[torch.device("cpu")] * S))


def carry(j: JaxSharded, mesh, **kw) -> ShardedIVFIndex:
    """A port index of ``j``'s configuration with its coarse quantizer and
    codec (no rows)."""
    t = ShardedIVFIndex(D, mesh, nlist=j.nlist, seed=j.seed, **kw)
    t.centroids = np.array(j.centroids, np.float32)
    for name in ("_pq_books", "_pq_rot"):
        value = getattr(j, name)
        if value is not None:
            setattr(t, name, torch.from_numpy(np.array(value, np.float32)))
    return t


def slot_values(index) -> np.ndarray:
    """Stored values per global slot ``[nlist, S * lcap, cols]``: rows, or
    int4 / pq nibbles, of either package's index."""
    if isinstance(index, JaxSharded):
        b = np.asarray(index._dblocks)
        if index.dtype in NIBBLE:
            w = b.view(np.uint32)
            u = np.stack([(w >> (4 * j)) & 0xF for j in range(8)], axis=2)
            return u.reshape(b.shape[0], -1, b.shape[2]).astype(np.float32)
        return b.astype(np.float32)
    parts = []
    for shard in index._shards.values():
        b = shard._dblocks
        if index.dtype in NIBBLE:
            b = torch.stack([b & 0x0F, b >> 4], dim=2).reshape(
                b.shape[0], -1, b.shape[2])
        parts.append(b.float().numpy())
    return np.concatenate(parts, axis=1)


def planes(t: ShardedIVFIndex, name: str) -> np.ndarray:
    return np.concatenate([getattr(sh, name).float().numpy()
                           for sh in t._shards.values()], axis=1)


def assert_same_layout(j, t, exact: bool = True) -> None:
    assert t._local_capacity == j._local_capacity
    assert t._count == j._count and t.nlist == j.nlist
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(t._ids, j._ids)
    np.testing.assert_array_equal(t._valid, j._valid)
    np.testing.assert_array_equal(planes(t, "_dids"), np.asarray(j._dids))
    np.testing.assert_array_equal(planes(t, "_dvalid"),
                                  np.asarray(j._dvalid))
    live = j._valid
    a, b = slot_values(j)[live], slot_values(t)[live]
    sa, sb = np.asarray(j._dscale)[live], planes(t, "_dscale")[live]
    if exact:
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(sb, sa)
    elif t.dtype == "pq":  # books retrained from centroids within 1e-5
        assert (a == b).mean() > 0.97
    else:
        assert np.abs(b - a).max() <= 1
        np.testing.assert_allclose(sb, sa, rtol=1e-4)
    if j._refine is not None and j._refine.count:
        r, rl = t._refine, j._refine.lcap
        assert (r.lcap, r.count) == (rl, j._refine.count)
        rows = np.asarray(j._refine.rows).astype(np.float32)
        for p in range(S):
            # Slot m of shard p holds id m * S + p (the JAX store's padding
            # rows land past the count).
            used = np.arange(rl) * S + p < r.count
            np.testing.assert_array_equal(
                r.rows[p].float().numpy()[used],
                rows[p * rl: (p + 1) * rl][used])
            if r.dtype == "int8":
                np.testing.assert_array_equal(
                    r.scales[p].numpy()[used],
                    np.asarray(j._refine.scales)[p * rl: (p + 1) * rl][used])


def jax_stage1(j, t, queries, nprobe, k, mask):
    """The JAX shards' Pallas probe scans (interpret mode) on the port's
    probes and centroid scores, then ``lax.top_k`` over the shard-major
    concatenation: the JAX program's coarse stage as deployed."""
    import jax.numpy as jnp

    cs, probe = probe_clusters(torch.from_numpy(queries), t._dcent, t.metric,
                               nprobe)
    probe_j, qj = jnp.asarray(probe.numpy()), jnp.asarray(queries)
    cbias = (jnp.asarray(torch.gather(cs, 1, probe.long()).numpy())
             if j.by_residual else None)
    lcap = j._local_capacity
    blocks, scale = np.asarray(j._dblocks), np.asarray(j._dscale)
    block_mask, dsq = np.asarray(j.device_block_mask(mask)), np.asarray(j._dsq)
    scores, ids = [], []
    for s in range(S):
        sl = slice(s * lcap, (s + 1) * lcap)
        fills = jnp.asarray(j._fill[:, s])
        if j.dtype in ("int8", "int4"):
            fn = pallas_ivf_topk_int8 if j.dtype == "int8" else (
                pallas_ivf_topk_int4)
            rows = slice(s * lcap // 8, (s + 1) * lcap // 8) if (
                j.dtype == "int4") else sl
            sc, pos = fn(jnp.asarray(blocks[:, rows]),
                         jnp.asarray(scale[:, sl]),
                         jnp.where(block_mask[:, sl], 0.0, -jnp.inf), fills,
                         probe_j, qj, k, tile_n=ALIGN, interpret=True,
                         cbias=cbias)
        else:
            live = dsq[:, sl] if j.metric == "l2" else 0.0
            sc, pos = pallas_ivf_topk(
                jnp.asarray(blocks[:, sl]),
                jnp.where(block_mask[:, sl], live, jnp.inf), fills, probe_j,
                qj, k, tile_n=ALIGN, interpret=True, metric=j.metric)
        sc, pos = np.asarray(sc), np.asarray(pos)
        scores.append(sc)
        ids.append(np.where(np.isfinite(sc),
                            j._ids[:, sl].reshape(-1)[np.clip(pos, 0, None)],
                            -1))
    top, sel = jax.lax.top_k(jnp.asarray(np.concatenate(scores, axis=1)), k)
    return np.asarray(top), np.take_along_axis(np.concatenate(ids, axis=1),
                                               np.asarray(sel), axis=1)


def port_stage1(t, queries, nprobe, k, mask):
    """The port's coarse stage alone (no refine rescore)."""
    key, buffers = t.make_scan_fn(nprobe)
    stride = 6 if t.dtype == "pq" else 4
    key = key[:8] + (0,) + key[9:]
    s, i = sharded_ivf_scan(key, buffers[: stride * S], t.scan_staged(mask),
                            torch.from_numpy(queries), k)
    return s.numpy(), i.numpy()


def assert_close(want, got, tol, rel=False):
    """Scores within ``tol`` (relative with ``rel``), ids equal outside
    near-ties."""
    (ws, wi), (gs, gi) = want, got
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    bound = tol * np.maximum(np.abs(ws), 1.0) if rel else tol
    diff = np.abs(np.where(fin, gs - ws, 0.0))
    assert (diff <= bound).all(), diff.max()
    assert ((gi == wi) | (diff <= 2 * bound)).all()


def check_searches(j, t, mask=None, stage1=()):
    """``search`` against the JAX index's, and at each ``(nprobe, k)`` of
    ``stage1`` the coarse stage against the Pallas kernels'."""
    queries = clustered(2, 6)
    exact = t.dtype in ("int8", "int4")
    if t.dtype != "pq":
        for nprobe, k in stage1:
            want = jax_stage1(j, t, queries, nprobe, k, mask)
            got = port_stage1(t, queries, nprobe, k, mask)
            if exact:
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
            else:
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    tol = 1e-4 if exact else 1e-5
    for nprobe in (2, NLIST):
        want = j.search(queries, 10, mask=mask, nprobe=nprobe)
        got = t.search(queries, 10, mask=mask, nprobe=nprobe)
        assert got[1].dtype == np.int64 and got[0].shape == (6, 10)
        assert_close(want, got, tol, rel=not exact)


FLOAT_CASES = ("f32", "f32_l2", "bf16", "bf16_l2")


def make_pair(case: str, meshes):
    """A JAX index of ``CASES[case]`` over 1,200 rows and the port index
    carried from it, after the same add."""
    kw = CASES[case]
    jmesh, tmesh = meshes
    j = JaxSharded(D, jmesh, nlist=NLIST, seed=3, **kw)
    j.add(clustered(0, 1200))
    t = carry(j, tmesh, **kw)
    np.testing.assert_array_equal(t.add(clustered(0, 1200)),
                                  np.arange(1200))
    return j, t


@pytest.fixture(scope="module", params=FLOAT_CASES)
def pair(request, meshes):
    return make_pair(request.param, meshes)


def test_lifecycle_matches_jax(pair):
    j, t = pair
    assert_same_layout(j, t)
    assert (t.by_residual, t.refine_dtype, t.pq_m) == (
        j.by_residual, j.refine_dtype, j.pq_m)
    more = clustered(3, 3000, centers=2)  # two hot clusters: growth
    cap = t._local_capacity
    np.testing.assert_array_equal(t.add(more), j.add(more))
    assert t._local_capacity > cap
    assert_same_layout(j, t)
    gone = np.arange(5, t.ntotal, 3)
    assert t.remove(gone) == j.remove(gone)
    assert t.remove(gone) == 0
    assert_same_layout(j, t)
    check_searches(j, t, stage1=[(NLIST, 40)])
    check_searches(j, t, mask=np.arange(t.ntotal) % 4 != 1, stage1=[(3, 10)])
    assert t.compact() == j.compact()
    assert_same_layout(j, t)
    check_searches(j, t)
    live = int(j._valid.sum())
    n_train = min(live, max(50 * NLIST, 1000))
    init, noise = jax_train_randomness(j.seed, n_train, NLIST, D,
                                       j.train_iters)
    j.rebalance(train_sample=1000)
    t.rebalance(train_sample=1000, init_idx=init, noise=noise)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-5)
    assert_same_layout(j, t, exact=not (j.by_residual or j.dtype == "pq"))
