"""The port's pq IVF index against ``tpu_search``'s on the CPU.

A JAX pq index (plain, with OPQ, and with an int8 refine tier) is built and
carried into the port with ``ivf_index_from_numpy``: its ``[nlist, cap/8,
M]`` code words become nibble-pair bytes, its books and rotation device
tensors.  Then, on the same queries:

- ``search`` (with and without a filter mask, k 10 and 150, nprobe 2 and
  all): ids equal outside ties, scores within 1e-5;
- ``make_scan_fn`` + ``ivf_scan`` (the fused path's function) equal to
  ``search``;
- adds across nibble boundaries, remove plus compact: the same layout and
  codes, the same answers; rebalance (the JAX package's k-means randomness
  handed to the port, the books retrained from the same numpy draws): the
  same centroids and layout, books, codes and answers agreeing but for
  rows near a tie;
- TPUSIDX2 files written by either package, read by the other: the same
  header keys and answers.

Then the cases of ``tests/test_index_ivf_pq.py`` on the port (collected
from their source, without their ``slow`` marks; its ``make_pq`` trains
the port index's coarse quantizer and books in the JAX package).  Its
``TestScanKeyPath`` calls the JAX package's fused-path function
``ivf_scan_fn_for``; here it holds the port's ``make_scan_fn`` /
``ivf_scan`` to ``search`` instead.
"""

import numpy as np
import pytest
import torch

from test_torch_ivf_index import jax_train_randomness
from test_torch_pq_codec import (
    one_thread,
    port_cases,
    port_scan_matches_search,
)
from tpu_search.index.ivf import IVFIndex as JaxIVF
from tpu_search_torch.index.ivf import (
    IVFIndex,
    ivf_index_from_numpy,
    ivf_scan,
)
from tpu_search_torch.index.registry import load_index

D, NLIST, TOL = 64, 8, 1e-5
KINDS = {"pq": {}, "opq": {"opq": True},
         "refine": {"refine_dtype": "int8", "refine_factor": 3}}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The port's indexes and engines default to the CPU here (their
    module-scoped fixtures included), on one thread (``one_thread``)."""
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        yield


def clustered(seed, n, d=D, centers=12):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + 0.4 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def carry(j: JaxIVF) -> IVFIndex:
    """The port index with the JAX pq index's state."""
    header = {
        "dim": j.dim, "metric": j.metric, "dtype": j.dtype, "nlist": j.nlist,
        "count": j._count, "cluster_capacity": j._cluster_capacity,
        "by_residual": j.by_residual, "nprobe_hint": j.nprobe_hint,
        "nprobe_tuned_live": j._tuned_live, "refine_dtype": j.refine_dtype,
        "refine_factor": j.refine_factor, "pq_auto": j.pq_auto,
        "pq_target_recall": j.pq_target_recall, "pq_m": j.pq_m,
        "opq": j.opq, "pq_tune": j._pq_tune_report,
    }
    arrays = {
        "centroids": np.asarray(j.centroids), "blocks": np.asarray(j._dblocks),
        "ids": j._ids, "valid": j._valid, "fill": j._fill,
        "sq": np.asarray(j._dsq), "scale": np.asarray(j._dscale),
        "pq_books": np.asarray(j._pq_books),
    }
    if j._pq_rot is not None:
        arrays["pq_rot"] = np.asarray(j._pq_rot)
    if j._refine is not None and j._refine.count:
        arrays["refine_rows"] = np.asarray(j._refine.rows)[: j._refine.count]
        if j._refine.scales is not None:
            arrays["refine_scales"] = np.asarray(j._refine.scales)[
                : j._refine.count]
    return ivf_index_from_numpy(header, arrays, device="cpu")


def codes_of(index) -> np.ndarray:
    """Per-slot code rows ``[nlist, cap, M]`` of either package's index."""
    if isinstance(index, JaxIVF):
        w = np.asarray(index._dblocks).view(np.uint32)
        u = np.stack([(w >> (4 * j)) & 0xF for j in range(8)], axis=2)
        return u.reshape(w.shape[0], -1, w.shape[2]).astype(np.uint8)
    b = index._dblocks
    return torch.stack([b & 0x0F, b >> 4], dim=2).reshape(
        b.shape[0], -1, b.shape[2]).numpy()


def assert_same_layout(j: JaxIVF, t: IVFIndex, codes_equal: bool = True):
    assert (t._cluster_capacity, t._count, t.pq_m) == (
        j._cluster_capacity, j._count, j.pq_m)
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(t._ids, j._ids)
    np.testing.assert_array_equal(t._valid, j._valid)
    np.testing.assert_array_equal(t._dvalid.numpy(), np.asarray(j._dvalid))
    np.testing.assert_array_equal(t._dids.numpy(), np.asarray(j._dids))
    live = j._valid
    a, b = codes_of(j)[live], codes_of(t)[live]
    if codes_equal:
        np.testing.assert_array_equal(b, a)
    else:  # re-encoded through books that agree within 1e-4
        assert (a == b).mean() > 0.99


def assert_same_results(want, got, tol=TOL):
    (ws, wi), (gs, gi) = want, got
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=0, atol=tol)
    assert ((gi == wi) | (np.abs(gs - ws) <= tol)).all()


def build(kind, n=1600):
    j = JaxIVF(D, dtype="pq", nlist=NLIST, **KINDS[kind])
    j.add(clustered(0, n))
    return j


@pytest.fixture(scope="module", params=sorted(KINDS))
def pair(request):
    j = build(request.param)
    j.remove(np.arange(0, j._count, 7))
    return j, carry(j)


def test_carried_state(pair):
    j, t = pair
    assert (t.dtype, t.pq_m, t.opq, t.by_residual, t.refine_dtype) == (
        "pq", j.pq_m, j.opq, True, j.refine_dtype)
    assert t._dblocks.dtype == torch.uint8
    assert tuple(t._dblocks.shape) == (NLIST, j._cluster_capacity // 2, j.pq_m)
    np.testing.assert_array_equal(t._pq_books.numpy(), np.asarray(j._pq_books))
    assert (t._pq_rot is None) == (j._pq_rot is None)
    assert_same_layout(j, t)


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
        assert_same_results(want, got)
        if mask is not None:
            hit = got[1][got[1] >= 0]
            assert mask[hit].all()


def test_scan_fn_matches_search(pair):
    """The fused path's function over ``make_scan_fn``'s buffers answers
    as ``search``; the key carries OPQ, the buffers the books and
    rotation."""
    j, t = pair
    queries = clustered(3, 5)
    mask = np.arange(j._count) % 3 != 0
    scan_key, buffers = t.make_scan_fn(4)
    assert scan_key[1] == "pq" and scan_key[-1] == t.opq
    assert buffers[6] is t._pq_books and buffers[7] is t._pq_rot
    s, ids = ivf_scan(scan_key, buffers, t.scan_staged(mask),
                      torch.from_numpy(queries), 10)
    ids = ids.numpy().astype(np.int64)
    ids[~np.isfinite(s.numpy())] = -1
    want = t.search(queries, 10, mask=mask, nprobe=4)
    np.testing.assert_array_equal(s.numpy(), want[0])
    np.testing.assert_array_equal(ids, want[1])
    assert_same_results(j.search(queries, 10, mask=mask, nprobe=4),
                        (s.numpy(), ids))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_add_remove_compact_match(kind):
    j = build(kind, n=700)
    t = carry(j)
    rows = clustered(4, 400)
    lo = 0
    for size in (3, 5, 1, 9, 2, 13, 7, 300):  # odd slots: nibble boundaries
        part = rows[lo: lo + size]
        np.testing.assert_array_equal(t.add(part), j.add(part))
        lo += size
    assert_same_layout(j, t)
    gone = np.arange(5, j._count, 3)
    assert t.remove(gone) == j.remove(gone)
    assert t.remove(gone) == 0
    assert t.compact() == j.compact()
    assert_same_layout(j, t)
    queries = clustered(5, 4)
    assert_same_results(j.search(queries, 10, nprobe=3),
                        t.search(queries, 10, nprobe=3))


@pytest.mark.parametrize("kind", ["pq", "refine"])
def test_rebalance_matches_with_jax_randomness(kind):
    """Rows decode through the old codec and re-encode through books
    retrained on the new centroids, in both packages."""
    j = build(kind, n=1200)
    j.add(clustered(6, 600, centers=2))  # skew two clusters
    j.remove(np.arange(0, j._count, 5))
    t = carry(j)
    live = int(j._valid.sum())
    init, noise = jax_train_randomness(j.seed, live, NLIST, D, j.train_iters)
    j.rebalance()
    t.rebalance(init_idx=init, noise=noise)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-5)
    # The books retrain on residuals against those centroids: a training
    # row on a cluster boundary may take the other cluster in one package
    # and move a centroid's Lloyd mean, so most entries, not all, agree.
    close = np.abs(t._pq_books.numpy() - np.asarray(j._pq_books)) <= 1e-4
    assert close.mean() >= 0.95
    assert_same_layout(j, t, codes_equal=False)
    queries = clustered(7, 4)
    want = j.search(queries, 10, nprobe=NLIST)
    got = t.search(queries, 10, nprobe=NLIST)
    # Codes re-encoded on either side of a near-tie move a score by one
    # centroid step; most answers stay the same.
    assert (got[1] == want[1]).mean() >= 0.9


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tpusidx2_both_directions(tmp_path, kind):
    from tpu_search_torch.index.serialize import read_file as port_read
    from tpu_search.index.serialize import read_file as jax_read

    j = build(kind, n=701)
    j.remove(np.arange(1, j._count, 4))
    j.nprobe_hint = 4
    t = carry(j)
    queries = clustered(8, 3)
    j.save(str(tmp_path / "jax.idx"))
    from_jax = load_index(str(tmp_path / "jax.idx"), device="cpu")
    assert isinstance(from_jax, IVFIndex) and from_jax.dtype == "pq"
    assert (from_jax.opq, from_jax.nprobe_hint) == (j.opq, 4)
    assert_same_layout(j, from_jax)
    assert_same_results(t.search(queries, 10, nprobe=3),
                        from_jax.search(queries, 10, nprobe=3), 0.0)
    t.save(str(tmp_path / "port.idx"))
    from_port = JaxIVF.load(str(tmp_path / "port.idx"))
    assert (from_port.dtype, from_port.pq_m, from_port.opq) == (
        "pq", j.pq_m, j.opq)
    assert_same_layout(from_port, t)
    assert_same_results(j.search(queries, 10, nprobe=3),
                        from_port.search(queries, 10, nprobe=3))
    hj, aj = jax_read(str(tmp_path / "jax.idx"))
    hp, ap = port_read(str(tmp_path / "port.idx"))
    assert hp == hj
    for name in ("pq_books", "pq_rot", "vectors", "ids", "valid", "fill"):
        assert (name in ap) == (name in aj)
        if name in aj:
            np.testing.assert_array_equal(np.asarray(ap[name]),
                                          np.asarray(aj[name]))


def test_construction_follows_jax():
    for kwargs in ({"dtype": "pq"}, {"dtype": "pq", "opq": True},
                   {"dtype": "pq", "pq_m": 8, "pq_auto": True},
                   {"dtype": "int4", "pq_m": 16, "opq": True},
                   {"dtype": "int8", "opq": True, "pq_auto": True}):
        j, t = JaxIVF(D, **kwargs), IVFIndex(D, device="cpu", **kwargs)
        assert (t.pq_m, t.opq, t.by_residual, t.pq_auto, t.refine_dtype) == (
            j.pq_m, j.opq, j.by_residual, j.pq_auto, j.refine_dtype)
    for bad in ({"dtype": "pq", "metric": "l2"}, {"dtype": "pq", "pq_m": 7}):
        with pytest.raises(ValueError):
            IVFIndex(D, device="cpu", **bad)


class _JaxRandomIVF(IVFIndex):
    """A port index whose ``rebalance`` retrains with the JAX package's
    k-means randomness."""

    def rebalance(self, train_sample=500_000, seed=None):
        live = int(self._valid.sum())
        n_train = min(live, max(50 * self.nlist, train_sample))
        init, noise = jax_train_randomness(self.seed, n_train, self.nlist,
                                           self.dim, self.train_iters)
        return super().rebalance(train_sample, seed, init_idx=init,
                                 noise=noise)


def make_pq(corpus, nlist=32, pq_m=16, **kw):
    """A trained, empty port pq index with the JAX package's coarse
    quantizer and books, retraining with its k-means randomness (a
    ``jax.random`` k-means cannot be reproduced from a seed), so that the
    recall the JAX cases assert is the JAX index's own."""
    j = JaxIVF(dim=32, dtype="pq", nlist=nlist, pq_m=pq_m, **kw)
    j.train(corpus)
    t = _JaxRandomIVF(dim=32, dtype="pq", nlist=nlist, pq_m=pq_m,
                      device="cpu", **kw)
    t.centroids = np.array(j.centroids, np.float32)
    t._dcent = torch.from_numpy(t.centroids.copy())
    t._pq_books = torch.from_numpy(np.array(j._pq_books, np.float32))
    return t


_CASES = port_cases("test_index_ivf_pq", drop=("TestScanKeyPath",),
                    overrides={"make_pq": make_pq})
globals().update(_CASES)


class TestScanKeyPath:
    def test_make_scan_fn_matches_search(self, corpus, queries):
        ivf = make_pq(corpus, nlist=16)
        ivf.add(corpus[:800])
        port_scan_matches_search(ivf, queries, 5, 4)


def test_smoke_gate_reference_on_the_cpu(pair):
    """``chip_smoke.pq_table_lookup``, the float64 reference of the card's
    ``[pq]`` gate, agrees with the scan here: scores within
    ``chip_smoke.PQ_TOL``, ids equal outside ties."""
    from chip_smoke import PQ_TOL, pq_table_lookup
    from tpu_search_torch.index.ivf import probe_clusters

    _, t = pair
    queries = torch.from_numpy(clustered(9, 8))
    for k in (10, 128):
        _, probe = probe_clusters(queries, t._dcent, "ip", 4)
        ks, ki = t._scan(queries, 4, k, t._penalty(None))
        rs, ri = pq_table_lookup(t, queries, probe, k)
        fin = torch.isfinite(rs)
        assert torch.equal(torch.isfinite(ks), fin)
        assert float((ks[fin].double() - rs[fin]).abs().max()) <= PQ_TOL
        assert bool(((ki.long() == ri)
                     | ((ks.double() - rs).abs() <= PQ_TOL)).all())
