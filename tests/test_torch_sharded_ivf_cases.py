"""The JAX package's sharded IVF tests on the port's ``ShardedIVFIndex``
(``tpu_search_torch/parallel/sharded_ivf.py``), on the CPU over 8 shards
that share the host (the port's ``build_mesh`` over the 8 devices
``XLA_FLAGS`` gives the JAX package's CPU mesh).

Collected from their source with ``tpu_search.`` pointed at
``tpu_search_torch.``, ``jnp.asarray`` at ``torch.as_tensor`` and without
their ``slow`` marks:

- every class of ``tests/test_sharded_ivf.py``;
- ``TestShardedTuneNprobe`` of ``tests/test_nprobe_autotune.py`` and
  ``TestShardedCalibration`` of ``tests/test_quant_calibration.py``.

Changed where a case reads the JAX package's machinery:
``test_fused_scan_fn_matches_classic`` calls ``sharded_ivf_scan_fn_for``
under ``jax.jit``; here it holds the port's ``make_scan_fn`` /
``sharded_ivf_scan`` to ``search``.  ``test_capacity_growth_preserves_rows``
shrinks ``_SLOT_ALIGN`` to 8 to force growths with small batches; the
port's probe scans take clusters in 128-slot tiles (``ops.ivf_scan.
IVF_TILE``), so here it aligns to 128 and adds 6,400 rows in batches of
800, growing the local capacity at least twice.  ``TestPQLifecycle``'s
``test_rebalance_reencodes`` asserts a statistical overlap of a pq index
before and after a retrain; here the index starts from the JAX index's
coarse quantizer and books and retrains with its k-means randomness, as
``tests/test_torch_ivf_pq.py`` does for the single-device pq cases (the
port's k-means draws from a torch generator).
"""

import numpy as np
import pytest
import torch

from test_torch_pq_codec import one_thread, port_cases
from tpu_search_torch.parallel.sharded_ivf import (
    ShardedIVFIndex,
    sharded_ivf_scan,
)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The port's indexes default to the CPU here, on one thread."""
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        yield


_CASES = port_cases("test_sharded_ivf",
                    replace=(("jnp.asarray(", "torch.as_tensor("),))
globals().update(_CASES)
normed = _CASES["normed"]


class TestMutation(_CASES["TestMutation"]):
    def test_capacity_growth_preserves_rows(self, mesh):
        import tpu_search_torch.parallel.sharded_ivf as m

        rng = np.random.default_rng(4)
        old_align = m._SLOT_ALIGN
        m._SLOT_ALIGN = 128
        try:
            sharded = ShardedIVFIndex(
                dim=16, mesh=mesh, dtype="float32", nlist=2
            )
            all_rows = normed(rng, 6400, 16)
            sharded.train(all_rows[:64])
            caps = set()
            for c0 in range(0, 6400, 800):
                sharded.add(all_rows[c0: c0 + 800])
                caps.add(sharded._local_capacity)
            assert len(caps) >= 3, caps  # grew at least twice
            assert sharded.ntotal == 6400 and sharded.live == 6400
            _, got = sharded.search(all_rows[::97], k=1, nprobe=2)
            want = np.arange(6400)[::97]
            assert (got[:, 0] == want).all()
        finally:
            m._SLOT_ALIGN = old_align


class TestPQLifecycle(_CASES["TestPQLifecycle"]):
    def test_rebalance_reencodes(self, mesh, corpus, queries):
        """The JAX case's statistical overlap, on the JAX index's coarse
        quantizer and books, retrained with its k-means randomness (a
        ``jax.random`` k-means cannot be reproduced from a seed; the port's
        sharded rebalance equals its single-device one bit for bit, and
        ``tests/test_torch_ivf_pq.py`` takes the same step)."""
        from test_torch_ivf_index import jax_train_randomness
        from tpu_search.parallel import ShardedIVFIndex as JaxSharded
        from tpu_search.parallel import build_mesh as jax_build_mesh

        j = JaxSharded(dim=32, mesh=jax_build_mesh(n_data=8), dtype="pq",
                       pq_m=16, nlist=8, seed=3)
        j.train(corpus)
        sharded = ShardedIVFIndex(
            dim=32, mesh=mesh, dtype="pq", pq_m=16, nlist=8, seed=3
        )
        sharded.centroids = np.array(j.centroids, np.float32)
        sharded._pq_books = torch.from_numpy(np.array(j._pq_books, np.float32))
        sharded.add(corpus)
        s1, i1 = sharded.search(queries, k=10, nprobe=8)
        init, noise = jax_train_randomness(3, 1000, 8, 32,  # n_train
                                           sharded.train_iters)
        sharded.rebalance(train_sample=1000, init_idx=init, noise=noise)
        assert sharded.ntotal == len(corpus)
        assert sharded.live == len(corpus)
        s2, i2 = sharded.search(queries, k=10, nprobe=8)
        overlap = np.mean([
            len(set(a) & set(b)) / 10.0 for a, b in zip(i1, i2)
        ])
        assert overlap >= 0.6, overlap
        np.testing.assert_allclose(s1[:, 0], s2[:, 0], atol=0.12)


class TestRefineLifecycle(_CASES["TestRefineLifecycle"]):
    def test_fused_scan_fn_matches_classic(self, mesh, clustered):
        x, q, _ = clustered
        idx = ShardedIVFIndex(
            dim=64, mesh=mesh, dtype="pq", nlist=24, seed=3,
            refine_dtype="bfloat16", refine_factor=4,
        )
        idx.add(x)
        s1, i1 = idx.search(q, 10, nprobe=6)
        scan_key, buffers = idx.make_scan_fn(6)
        assert scan_key[0] == "sharded_ivf" and scan_key[8] == 4
        s2, i2 = sharded_ivf_scan(scan_key, buffers, idx.scan_staged(None),
                                  torch.from_numpy(q), 10)
        np.testing.assert_array_equal(i1, i2.numpy())
        np.testing.assert_allclose(s1, s2.numpy(), rtol=1e-6)


class TestShardedTuneNprobe(
        port_cases("test_nprobe_autotune")["TestShardedTuneNprobe"]):
    @pytest.fixture(scope="class")
    def corpus(self):
        """``tests/test_nprobe_autotune.py``'s module corpus (this module's
        is ``tests/test_sharded_ivf.py``'s)."""
        rng = np.random.default_rng(21)
        centers = normed(rng, 16, 32)
        rows = []
        for _ in range(1600):
            c = centers[rng.integers(0, 16)]
            rows.append(c + 0.12 * rng.standard_normal(32))
        data = np.asarray(rows, dtype=np.float32)
        return data / np.linalg.norm(data, axis=1, keepdims=True)


TestShardedCalibration = port_cases(
    "test_quant_calibration")["TestShardedCalibration"]
