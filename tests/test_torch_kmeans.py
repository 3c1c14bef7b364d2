"""The port's balanced k-means against ``tpu_search.ops.kmeans`` on the CPU.

The JAX function draws its first centroids with ``jax.random.choice`` and
its respawn noise with ``jax.random.normal(fold_in(key, t))``; the test
draws those numbers from the same key and hands them to the port
(``init_idx``, ``noise``).  Tolerances: assignments equal; centroids
within 1e-5 (f32 sums of the same products in another order).  Chunked
runs shrink both modules' ``_CHUNK`` / ``_SINGLE_SHOT_ELEMS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.ops import kmeans as jkm
from tpu_search_torch.ops import kmeans as tkm

T = torch.from_numpy


def clustered(seed, n, d, centers=16, spread=0.15):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + spread * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def jax_randomness(seed, n, k, d, iters):
    """The init indices and per-iteration noise ``kmeans(PRNGKey(seed))``
    draws inside its jit."""
    key = jax.random.PRNGKey(seed)
    init = np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))
    noise = np.stack([
        np.asarray(jax.random.normal(
            jax.random.fold_in(key, jnp.int32(t)), (k, d)))
        for t in range(iters)
    ])
    return T(init.astype(np.int64)), T(noise)


@pytest.fixture(params=["single", "chunked"])
def mode(request, monkeypatch):
    if request.param == "chunked":
        for mod in (jkm, tkm):
            monkeypatch.setattr(mod, "_CHUNK", 512)
            monkeypatch.setattr(mod, "_SINGLE_SHOT_ELEMS", 1000)
    return request.param


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_assign_clusters_equal(mode, metric):
    x = clustered(1, 1500 if mode == "chunked" else 1400, 32)
    cent = clustered(2, 24, 32)
    want = np.asarray(jkm.assign_clusters(jnp.asarray(x), jnp.asarray(cent),
                                          metric))
    got = tkm.assign_clusters(T(x), T(cent), metric).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("balance", [0.5, -1.0])
def test_kmeans_matches_jax_with_its_randomness(mode, metric, balance):
    n = 1200 + (7 if mode == "chunked" else 3) + (2 if metric == "l2" else 0)
    n += 1 if balance > 0 else 0  # a fresh jit trace per case
    d, k, iters, seed = 32, 16, 10, 3
    x = clustered(4, n, d)
    jc, ja = jkm.kmeans(jax.random.PRNGKey(seed), jnp.asarray(x), k,
                        iters=iters, metric=metric, balance=balance)
    init, noise = jax_randomness(seed, n, k, d, iters)
    tc, ta = tkm.kmeans(T(x), k, iters=iters, metric=metric, balance=balance,
                        init_idx=init, noise=noise)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_kmeans_generator_is_reproducible():
    x = T(clustered(5, 800, 16))
    runs = [tkm.kmeans(x, 8, generator=torch.Generator().manual_seed(7),
                       balance=0.5)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.allclose(runs[0].norm(dim=1), torch.ones(8))
