"""The port's PQ codec (``tpu_search_torch/ops/pq.py``) against
``tpu_search/ops/pq.py`` on the CPU, on the same numpy inputs.

- books carried across: codes equal wherever the best centroid leads the
  second by more than 1e-5; ``decode_pq`` and ``pq_lut`` within 1e-6;
  ``pq_block_scores`` within 1e-5, and the same whatever the batch shape;
- the same seed: ``train_pq`` books within 1e-4 on the clustered fixture;
  ``train_opq`` orthonormal within 1e-5, its reconstruction error within
  1 % of the JAX rotation's (the alternation amplifies f32 rounding, so the
  rotations themselves differ);
- the cases of ``tests/test_pq_codec.py`` and ``tests/test_opq.py`` on the
  port (collected from their source with ``tpu_search.`` pointed at
  ``tpu_search_torch.``, ``jnp.asarray`` at ``torch.as_tensor``, and
  without their ``slow`` marks: the port trains in a fraction of the JAX
  package's time on the CPU).  ``test_opq.py``'s
  ``test_fused_scan_fn_matches_classic`` calls the JAX package's fused-path
  function ``ivf_scan_fn_for``; here it holds the port's ``make_scan_fn``
  / ``ivf_scan`` to ``search`` instead.  Its ``TestSharded`` runs on the
  port's ``ShardedIVFIndex`` over 8 CPU shards.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.ops import pq as jpq
from tpu_search_torch.ops import pq as tpq


def port_cases(name: str, replace=(), drop=(), overrides=None) -> dict:
    """The test module ``tests/<name>.py`` with every ``tpu_search.``
    reference pointed at ``tpu_search_torch.`` (and ``replace``'s pairs
    applied), its ``slow`` marks removed, its helpers in ``overrides``
    replaced, minus the names in ``drop``: its fixtures, helpers and test
    classes, to collect here."""
    source = (Path(__file__).parent / f"{name}.py").read_text()
    source = source.replace("tpu_search.", "tpu_search_torch.")
    source = re.sub(r"^[ \t]*@pytest\.mark\.slow\n", "", source, flags=re.M)
    source = re.sub(r"^pytestmark = pytest\.mark\.slow.*$", "", source,
                    flags=re.M)
    for old, new in replace:
        source = source.replace(old, new)
    namespace = {"__name__": __name__, "__file__": __file__, "torch": torch}
    exec(compile(source, f"{name}.py on tpu_search_torch", "exec"), namespace)
    namespace.update(overrides or {})
    return {k: v for k, v in namespace.items()
            if not k.startswith("__") and k not in drop}


def port_scan_matches_search(ivf, queries, k, nprobe):
    """The port's fused-path function over ``make_scan_fn``'s buffers
    answers as ``search``."""
    from tpu_search_torch.index.ivf import ivf_scan

    scan_key, buffers = ivf.make_scan_fn(nprobe)
    s, i = ivf_scan(scan_key, buffers, ivf.scan_staged(None),
                    torch.from_numpy(np.asarray(queries, np.float32)), k)
    got = i.numpy().astype(np.int64)
    got[~np.isfinite(s.numpy())] = -1
    want = ivf.search(queries, k, nprobe=nprobe)
    np.testing.assert_array_equal(got, want[1])
    np.testing.assert_allclose(s.numpy(), want[0], rtol=1e-6)


@contextlib.contextmanager
def one_thread():
    """torch and the BLAS behind numpy on one thread each: the PQ tests'
    many small float64 products and 768 x 768 SVDs (OPQ) slow down tenfold
    when every test worker spins a pool of all the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(limits=1)
    try:
        with limits:
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The port's indexes and engines default to the CPU here (their
    module-scoped fixtures included), on one thread (:func:`one_thread`)."""
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        yield


globals().update(port_cases(
    "test_pq_codec", replace=(("jnp.asarray(", "torch.as_tensor("),)))
_OPQ = port_cases("test_opq", drop=("TestCodec",))
globals().update(_OPQ)
TestOPQCodec = port_cases("test_opq")["TestCodec"]


class TestIVFIntegration(_OPQ["TestIVFIntegration"]):
    def test_fused_scan_fn_matches_classic(self, correlated_corpus, queries):
        from tpu_search_torch.index.ivf import IVFIndex

        d = correlated_corpus.shape[1]
        opq = IVFIndex(dim=d, dtype="pq", nlist=16, seed=3, opq=True)
        opq.add(correlated_corpus)
        port_scan_matches_search(opq, queries, 10, 8)


@pytest.fixture(scope="module")
def jax_books(clustered):
    """Books of ``train_pq`` in the JAX package (seed 0, 12 iterations)."""
    return np.array(jpq.train_pq(clustered, m=16, iters=12, seed=0))


def test_train_pq_books_match(clustered, jax_books):
    got = tpq.train_pq(clustered, m=16, iters=12, seed=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 16, 4)
    np.testing.assert_allclose(got.numpy(), jax_books, rtol=0, atol=1e-4)


def test_train_pq_tiny_and_sampled_inputs_match():
    """Fewer than 16 rows tile; more than ``sample`` rows subsample with
    the same numpy draws."""
    rng = np.random.default_rng(3)
    for n, sample in ((5, 131072), (700, 300)):
        x = rng.standard_normal((n, 24)).astype(np.float32)
        want = np.asarray(jpq.train_pq(x, 6, iters=5, seed=2, sample=sample))
        got = tpq.train_pq(x, 6, iters=5, seed=2, sample=sample).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_codes_match_outside_near_ties(clustered, jax_books):
    x = np.concatenate([clustered, clustered[:4196]])  # two encode chunks
    want = np.asarray(jpq.encode_pq(x, jnp.asarray(jax_books)))
    got = tpq.encode_pq(x, torch.from_numpy(jax_books))
    assert got.dtype == torch.uint8
    got = got.numpy().astype(np.int64)
    sub = x.reshape(len(x), 16, 4)
    dist = (np.einsum("nmd,mkd->nmk", sub.astype(np.float64), jax_books)
            - 0.5 * (jax_books.astype(np.float64) ** 2).sum(-1)[None])
    top2 = np.sort(dist, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def test_decode_lut_and_block_scores_match(clustered, jax_books):
    codes = np.asarray(jpq.encode_pq(clustered[:512], jnp.asarray(jax_books)))
    books = torch.from_numpy(jax_books)
    np.testing.assert_allclose(
        tpq.decode_pq(torch.from_numpy(codes), books).numpy(),
        np.asarray(jpq.decode_pq(jnp.asarray(codes), jnp.asarray(jax_books))),
        rtol=0, atol=1e-6)
    q = clustered[1000:1008]
    want_lut = np.asarray(jpq.pq_lut(jnp.asarray(q), jnp.asarray(jax_books)))
    lut = tpq.pq_lut(torch.from_numpy(q), books)
    np.testing.assert_allclose(lut.numpy(), want_lut, rtol=0, atol=1e-6)
    want = np.asarray(jpq.pq_block_scores(jnp.asarray(codes),
                                          jnp.asarray(want_lut)))
    got = tpq.pq_block_scores(torch.from_numpy(codes), lut).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # One fixed summation order: a query's scores do not depend on the
    # batch it came in.
    for i in (0, 5):
        alone = tpq.pq_block_scores(torch.from_numpy(codes), lut[i: i + 1])
        np.testing.assert_array_equal(alone.numpy()[0], got[i])


def test_subspace_sum_orders_pairwise():
    x = torch.arange(1.0, 8.0)  # 7 entries: ((1+4)+(3+6)) + ((2+5)+7)
    assert float(tpq.subspace_sum(x)) == 28.0
    x = torch.tensor([1e8, 1.0, -1e8, 1.0])  # (1e8 - 1e8) + (1 + 1)
    assert float(tpq.subspace_sum(x)) == 2.0


@pytest.fixture(scope="module")
def jax_opq(correlated_corpus):
    rot, books = jpq.train_opq(correlated_corpus[:3000], 16, seed=1)
    return np.asarray(rot), np.asarray(books)


def _opq_error(x, rot, books):
    xr = x @ rot
    books = torch.as_tensor(books)
    rec = tpq.decode_pq(tpq.encode_pq(xr, books), books).numpy()
    return float(np.mean(np.sum((rec - xr) ** 2, axis=1)))


def test_train_opq_matches_jax_error(correlated_corpus, jax_opq):
    x = correlated_corpus[:3000]
    rot, books = tpq.train_opq(x, 16, seed=1)
    r = rot.numpy()
    assert rot.dtype == torch.float32 and tuple(books.shape) == (16, 16, 4)
    np.testing.assert_allclose(r @ r.T, np.eye(r.shape[0]), rtol=0, atol=1e-5)
    want = _opq_error(x, *jax_opq)
    assert abs(_opq_error(x, r, books.numpy()) - want) <= 0.01 * want


def test_ivf_training_matches(clustered):
    """``train_pq_for_ivf`` / ``train_opq_for_ivf`` residualize the same
    sample against the same centroids."""
    cents = clustered[::400][:8]
    want = np.asarray(jpq.train_pq_for_ivf(
        jnp.asarray(clustered), jnp.asarray(cents), "ip", 16,
        by_residual=True, seed=4, sample=2000))
    got = tpq.train_pq_for_ivf(clustered, cents, "ip", 16, by_residual=True,
                               seed=4, sample=2000).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rot, books = tpq.train_opq_for_ivf(clustered[:1500], cents, "ip", 16,
                                       by_residual=False, seed=4)
    r = rot.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(64), rtol=0, atol=1e-5)
