"""The port's ``FlatIndex`` against the JAX package's through the same
sequence of adds, removes, compaction and searches, and TPUSIDX2 files
read across packages both ways.

Tolerance: scores within 1e-5 (unit-norm rows, f32 sums in another
order); ids identical (random inputs carry no near-ties).
"""

import jax
import numpy as np
import pytest
import torch

from tpu_search.index.flat import FlatIndex as JaxFlatIndex
from tpu_search_torch.index.flat import FlatIndex

TOL = 1e-5
CPU = torch.device("cpu")


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def pair(metric, dtype, d=128):
    jax_index = JaxFlatIndex(d, metric=metric, dtype=dtype,
                             device=jax.devices("cpu")[0])
    return jax_index, FlatIndex(d, metric=metric, dtype=dtype, device=CPU)


def assert_same_search(a, b, queries, k, mask=None):
    sa, ia = a.search(queries, k, mask=mask)
    sb, ib = b.search(queries, k, mask=mask)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(sb, sa, rtol=TOL, atol=TOL)
    return sb, ib


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lifecycle_matches_jax(metric, dtype):
    rng = np.random.default_rng(0)
    jx, pt = pair(metric, dtype)
    first = normed(rng, 700, 128) * (1.5 if metric == "l2" else 1.0)
    second = normed(rng, 900, 128)
    queries = normed(rng, 5, 128)
    for batch in (first, second):  # grows past the 1024-slot minimum
        np.testing.assert_array_equal(pt.add(batch), jx.add(batch))
    assert pt.capacity == jx.capacity == 2048
    assert pt.ntotal == jx.ntotal == 1600
    assert_same_search(jx, pt, queries, 10)

    gone = rng.choice(1600, size=300, replace=False)
    assert pt.remove(gone) == jx.remove(gone) == 300
    assert pt.live == jx.live == 1300
    mask = rng.random(1600) < 0.5
    _, ids = assert_same_search(jx, pt, queries, 20, mask=mask)
    assert not np.isin(ids[ids >= 0], gone).any()

    assert pt.compact() == jx.compact()
    assert pt.ntotal == pt.live == 1300
    assert_same_search(jx, pt, queries, 128)


def test_device_tensor_add_uses_live_rows_only():
    rng = np.random.default_rng(1)
    index = FlatIndex(64, device=CPU)
    padded = torch.from_numpy(normed(rng, 256, 64))
    ids = index.add(padded, n=100)
    assert ids.tolist() == list(range(100)) and index.ntotal == 100
    scores, found = index.search(padded[:3].numpy(), 1)
    assert found[:, 0].tolist() == [0, 1, 2]
    np.testing.assert_allclose(scores[:, 0], 1.0, atol=1e-2)


def test_k_beyond_live_rows_pads_with_minus_one():
    rng = np.random.default_rng(2)
    index = FlatIndex(32, dtype="float32", device=CPU)
    index.add(normed(rng, 3, 32))
    scores, ids = index.search(normed(rng, 2, 32), 5)
    assert (ids[:, 3:] == -1).all() and np.isneginf(scores[:, 3:]).all()
    scores, ids = FlatIndex(32, device=CPU).search(normed(rng, 2, 32), 4)
    assert (ids == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_tpusidx2_interop_both_ways(tmp_path, dtype, metric):
    rng = np.random.default_rng(3)
    jx, pt = pair(metric, dtype)
    data = normed(rng, 1500, 128)
    jx.add(data)
    pt.add(data)
    gone = np.arange(0, 1500, 7)
    jx.remove(gone)
    pt.remove(gone)
    queries = normed(rng, 4, 128)

    jx.save(str(tmp_path / "jax.idx"))
    from_jax = FlatIndex.load(str(tmp_path / "jax.idx"), device=CPU)
    assert (from_jax.dtype, from_jax.metric, from_jax.ntotal) == (
        dtype, metric, 1500)
    assert_same_search(jx, from_jax, queries, 10)

    pt.save(str(tmp_path / "port.idx"))
    from_port = JaxFlatIndex.load(str(tmp_path / "port.idx"),
                                  device=jax.devices("cpu")[0])
    assert from_port.live == pt.live
    assert_same_search(from_port, pt, queries, 10)
    # the raw bytes of the two files agree section by section
    assert (tmp_path / "jax.idx").read_bytes() == (
        tmp_path / "port.idx").read_bytes()


def test_quantized_storage_is_refused():
    """The quantized storage a flat index cannot hold is refused as the
    JAX package refuses it: pq (IVF only) and int8/int4 with l2."""
    for dtype, metric in (("pq", "ip"), ("int8", "l2"), ("int4", "l2")):
        with pytest.raises(ValueError):
            FlatIndex(64, metric=metric, dtype=dtype, device=CPU)
        with pytest.raises(ValueError):
            JaxFlatIndex(64, metric=metric, dtype=dtype,
                         device=jax.devices("cpu")[0])
