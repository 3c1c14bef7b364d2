"""The port's ``IVFIndex`` against ``tpu_search``'s on the CPU.

A JAX index is built (its ``jax.random`` k-means cannot be reproduced from
a seed), and its state is carried into the port with
``ivf_index_from_numpy``.  Tolerances:

- stage 1 (the probe scan) on the same probes and cluster scores: int8 /
  int4 scores and ids bit-identical to ``pallas_ivf_topk_int8`` /
  ``_int4`` in interpret mode (the scan the JAX package deploys on its
  accelerator); bf16 / f32 ids equal, scores within 1e-5;
- the whole search against ``IVFIndex.search`` of the JAX package (its
  CPU path, the XLA grouped scan, and for int4 the refine re-rank): ids
  equal outside near-ties, scores within 1e-4 (``1 / qs1`` against
  ``/ qs1``, f32 sums in another order);
- ``add``, ``remove`` and ``compact``: slot metadata and the stored rows
  equal (int8 / int4 bit for bit); ``rebalance`` with the JAX package's
  k-means randomness handed to the port: centroids within 1e-5, layout
  equal; ``tune_nprobe`` and ``deployed_quant_calibration`` reports equal;
- TPUSIDX2 files: written by either package, read by the other, the same
  state and the same search results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.index.ivf import IVFIndex as JaxIVF
from tpu_search.ops.pallas_ivf_scan import (
    pallas_ivf_topk,
    pallas_ivf_topk_int4,
    pallas_ivf_topk_int8,
)
from tpu_search_torch.index.ivf import (
    IVFIndex,
    ivf_index_from_numpy,
    probe_clusters,
)
from tpu_search_torch.index.registry import load_index

D, NLIST = 64, 8
CASES = [("float32", "ip"), ("float32", "l2"), ("bfloat16", "ip"),
         ("bfloat16", "l2"), ("int8", "ip"), ("int4", "ip")]


def clustered(seed, n, d=D, centers=12):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + 0.4 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def carry(j: JaxIVF) -> IVFIndex:
    """The port index with the JAX index's state."""
    header = {
        "dim": j.dim, "metric": j.metric, "dtype": j.dtype, "nlist": j.nlist,
        "count": j._count, "cluster_capacity": j._cluster_capacity,
        "by_residual": j.by_residual, "nprobe_hint": j.nprobe_hint,
        "nprobe_tuned_live": j._tuned_live, "refine_dtype": j.refine_dtype,
        "refine_factor": j.refine_factor, "pq_auto": j.pq_auto,
        "pq_target_recall": j.pq_target_recall,
    }
    arrays = {
        "centroids": np.asarray(j.centroids), "blocks": np.asarray(j._dblocks),
        "ids": j._ids, "valid": j._valid, "fill": j._fill,
        "sq": np.asarray(j._dsq), "scale": np.asarray(j._dscale),
    }
    if j._refine is not None and j._refine.count:
        arrays["refine_rows"] = np.asarray(j._refine.rows)[: j._refine.count]
        if j._refine.scales is not None:
            arrays["refine_scales"] = np.asarray(j._refine.scales)[
                : j._refine.count]
    return ivf_index_from_numpy(header, arrays, device="cpu")


def stored_nibbles_or_rows(index) -> np.ndarray:
    """Block contents as per-slot values: rows, or int4 biased nibbles."""
    if isinstance(index, JaxIVF):
        b = np.asarray(index._dblocks)
        if index.dtype == "int4":
            w = b.view(np.uint32)
            u = np.stack([(w >> (4 * j)) & 0xF for j in range(8)], axis=2)
            return u.reshape(b.shape[0], -1, b.shape[2]).astype(np.uint8)
        return b.astype(np.float32)
    b = index._dblocks
    if index.dtype == "int4":
        return torch.stack([b & 0x0F, b >> 4], dim=2).reshape(
            b.shape[0], -1, b.shape[2]).numpy()
    return b.float().numpy()


def assert_same_layout(j: JaxIVF, t: IVFIndex, exact: bool = True) -> None:
    """Equal slot metadata; stored rows equal (``exact=False``: residual
    rows re-encoded against centroids that agree within 1e-5, so scales
    within 1e-4 relative and codes within one step)."""
    assert t._cluster_capacity == j._cluster_capacity
    assert t._count == j._count
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(t._ids, j._ids)
    np.testing.assert_array_equal(t._valid, j._valid)
    np.testing.assert_array_equal(t._dvalid.numpy(), np.asarray(j._dvalid))
    np.testing.assert_array_equal(t._dids.numpy(), np.asarray(j._dids))
    live = j._valid
    a, b = stored_nibbles_or_rows(j), stored_nibbles_or_rows(t)
    if exact:
        np.testing.assert_array_equal(b[live], a[live])
        np.testing.assert_array_equal(t._dscale.numpy()[live],
                                      np.asarray(j._dscale)[live])
    else:
        assert np.abs(b[live].astype(np.float32) - a[live]).max() <= 1
        np.testing.assert_allclose(t._dscale.numpy()[live],
                                   np.asarray(j._dscale)[live], rtol=1e-4)


def assert_same_results(want, got, tol):
    (ws, wi), (gs, gi) = want, got
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=tol)
    assert ((gi == wi) | (np.abs(gs - ws) <= tol)).all()


def build(dtype, metric, n=1600, pq_auto=None):
    j = JaxIVF(D, metric=metric, dtype=dtype, nlist=NLIST,
               pq_auto=dtype == "int4" if pq_auto is None else pq_auto)
    j.add(clustered(0, n))
    return j


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def pair(request):
    dtype, metric = request.param
    j = build(dtype, metric)
    j.remove(np.arange(0, j._count, 7))
    return j, carry(j)


def pallas_stage1(j: JaxIVF, t: IVFIndex, queries, nprobe, k, mask):
    """``_ivf_search_pallas_impl`` in interpret mode, on the port's probes
    and cluster scores (the centroid product sums in another order)."""
    cs, probe = probe_clusters(torch.from_numpy(queries), t._dcent, t.metric,
                               nprobe)
    probe_j = jnp.asarray(probe.numpy())
    block_mask = j.device_block_mask(mask)
    fills = jnp.asarray(j._fill)
    qj = jnp.asarray(queries)
    cbias = (jnp.asarray(torch.gather(cs, 1, probe.long()).numpy())
             if j.by_residual else None)
    if j.dtype in ("int8", "int4"):
        fn = pallas_ivf_topk_int8 if j.dtype == "int8" else pallas_ivf_topk_int4
        s, pos = fn(j._dblocks, j._dscale, jnp.where(block_mask, 0.0, -jnp.inf),
                    fills, probe_j, qj, k, tile_n=256, interpret=True,
                    cbias=cbias)
    else:
        live = j._dsq if j.metric == "l2" else 0.0
        s, pos = pallas_ivf_topk(j._dblocks, jnp.where(block_mask, live, jnp.inf),
                                 fills, probe_j, qj, k, tile_n=256,
                                 interpret=True, metric=j.metric)
    s, pos = np.asarray(s), np.asarray(pos)
    ids = np.where(np.isfinite(s), j._ids.reshape(-1)[np.clip(pos, 0, None)],
                   -1)
    return s, ids


@pytest.mark.parametrize("masked", [False, True])
def test_stage1_matches_pallas_kernel(pair, masked):
    j, t = pair
    queries = clustered(1, 5)
    mask = (np.arange(j._count) % 3 != 0) if masked else None
    want = pallas_stage1(j, t, queries, 3, 10, mask)
    qt = torch.from_numpy(queries)
    s, ids = t._scan(qt, 3, 10, t._penalty(mask))
    got = (s.numpy(), ids.numpy().astype(np.int64))
    if j.dtype in ("int8", "int4"):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert_same_results(want, got, 1e-5)
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [10, 150])
def test_search_matches_jax_index(pair, masked, k):
    j, t = pair
    queries = clustered(2, 6)
    mask = (np.arange(j._count) % 4 != 1) if masked else None
    for nprobe in (2, NLIST):
        want = j.search(queries, k, mask=mask, nprobe=nprobe)
        got = t.search(queries, k, mask=mask, nprobe=nprobe)
        assert got[1].dtype == np.int64 and got[0].shape == (6, k)
        assert_same_results(want, got, 1e-4)
        if mask is not None:
            hit = got[1][got[1] >= 0]
            assert mask[hit].all()


@pytest.mark.parametrize("dtype,metric", CASES)
def test_add_remove_compact_match(dtype, metric):
    j = build(dtype, metric, n=900)
    t = carry(j)
    more = clustered(3, 700)
    np.testing.assert_array_equal(t.add(more), j.add(more))  # grows capacity
    assert_same_layout(j, t)
    gone = np.arange(5, j._count, 3)
    assert t.remove(gone) == j.remove(gone)
    assert t.remove(gone) == 0
    assert_same_layout(j, t)
    assert t.compact() == j.compact()
    assert_same_layout(j, t)
    if j._refine is not None:
        n = j._refine.count
        assert t._refine.count == n
        np.testing.assert_array_equal(t._refine.rows[:n].numpy(),
                                      np.asarray(j._refine.rows)[:n])
    queries = clustered(4, 4)
    assert_same_results(j.search(queries, 10, nprobe=3),
                        t.search(queries, 10, nprobe=3), 1e-4)


def jax_train_randomness(seed, n, k, d, iters):
    key = jax.random.PRNGKey(seed)
    init = np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, jnp.int32(t)), (k, d))) for t in range(iters)])
    return torch.from_numpy(init.astype(np.int64)), torch.from_numpy(noise)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_rebalance_matches_with_jax_randomness(dtype):
    j = build(dtype, "ip", n=1200)
    j.add(clustered(5, 600, centers=2))  # skew two clusters
    j.remove(np.arange(0, j._count, 5))
    t = carry(j)
    live = int(j._valid.sum())
    init, noise = jax_train_randomness(j.seed, live, NLIST, D, j.train_iters)
    j.rebalance()
    t.rebalance(init_idx=init, noise=noise)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-5)
    assert_same_layout(j, t, exact=not j.by_residual)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tune_nprobe_report_matches(dtype):
    j = build(dtype, "ip", n=1500)
    t = carry(j)
    want = j.tune_nprobe(target_recall=0.95)
    got = t.tune_nprobe(target_recall=0.95)
    assert got == want
    assert t.nprobe_hint == j.nprobe_hint and t.nprobe_hint_fresh()


def test_deployed_quant_calibration_matches():
    j = build("int4", "ip", n=1500)
    assert j.refine_dtype == "int8" and j.pq_auto
    t = carry(j)
    want = j.calibrate_quant(target_recall=0.9)
    got = t.calibrate_quant(target_recall=0.9)
    assert got == want
    assert (t.refine_factor, t.nprobe_hint) == (j.refine_factor, j.nprobe_hint)


@pytest.mark.parametrize("dtype,metric", CASES)
def test_tpusidx2_both_directions(tmp_path, dtype, metric):
    j = build(dtype, metric, n=700)
    j.remove(np.arange(1, j._count, 4))
    j.nprobe_hint = 4
    t = carry(j)
    queries = clustered(6, 3)
    j.save(str(tmp_path / "jax.idx"))
    from_jax = load_index(str(tmp_path / "jax.idx"), device="cpu")
    assert isinstance(from_jax, IVFIndex) and from_jax.nprobe_hint == 4
    assert_same_layout(j, from_jax)
    # l2: the loader recomputes |v|^2, summed in another order
    tol = 1e-6 if metric == "l2" else 0.0
    assert_same_results(t.search(queries, 10, nprobe=3),
                        from_jax.search(queries, 10, nprobe=3), tol)
    t.save(str(tmp_path / "port.idx"))
    from_port = JaxIVF.load(str(tmp_path / "port.idx"))
    assert from_port.nprobe_hint == 4
    assert_same_layout(from_port, t)
    assert_same_results(j.search(queries, 10, nprobe=3),
                        from_port.search(queries, 10, nprobe=3), tol)


def test_empty_and_trained_empty_round_trip(tmp_path):
    t = IVFIndex(D, device="cpu", nlist=4)
    s, i = t.search(clustered(7, 2), 5)
    assert (i == -1).all() and np.isneginf(s).all()
    t.train(clustered(8, 64))
    t.save(str(tmp_path / "e.idx"))
    back = load_index(str(tmp_path / "e.idx"), device="cpu")
    assert back.is_trained and back.ntotal == 0
    rows = clustered(9, 40)
    back.add(rows)
    assert back.search(rows[:1], 3, nprobe=4)[1][0, 0] == 0


def test_refused_and_device_defaults(monkeypatch):
    with pytest.raises(NotImplementedError):
        IVFIndex(D, dtype="pq", device="cpu")
    with pytest.raises(NotImplementedError):
        IVFIndex(D, dtype="int8", opq=True, device="cpu")
    with pytest.raises(ValueError):
        IVFIndex(D, dtype="int8", metric="l2", device="cpu")
    monkeypatch.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
    assert IVFIndex(D).device == torch.device("cpu")
