"""The port's ``ShardedIVFIndex`` and ``tpu_search``'s on the CPU, each
over 8 shards (the fixtures and helpers of ``test_torch_sharded_ivf.py``):

- TPUSIDX2 files both ways: a JAX sharded save in the port's sharded and
  single-device indexes (the sharded load laid out slot for slot as the
  JAX sharded load of the same file), a port sharded save in the JAX
  sharded and single-device indexes, each answering as the index saved
  (f32, int4 with the int8 refine tier, pq with OPQ);
- ties: rows planted on several shards with equal scores come back lower
  shard first (a stable merge over the shard-major concatenation, as
  ``lax.top_k`` orders it), in both packages alike.
"""

import numpy as np
import pytest

from test_torch_sharded_ivf import (  # noqa: F401  (_env, meshes: fixtures)
    CASES,
    D,
    NLIST,
    S,
    _env,
    assert_close,
    assert_same_layout,
    carry,
    clustered,
    meshes,
)
from tpu_search.index.ivf import IVFIndex as JaxIVF
from tpu_search.parallel import ShardedIVFIndex as JaxSharded
from tpu_search_torch.index.ivf import IVFIndex
from tpu_search_torch.parallel import ShardedIVFIndex


@pytest.mark.parametrize("case", ["f32", "int4_refine", "pq_opq"])
def test_files_both_ways(case, meshes, tmp_path):
    kw = CASES[case]
    jmesh, tmesh = meshes
    j = JaxSharded(D, jmesh, nlist=NLIST, seed=3, **kw)
    j.add(clustered(4, 1500))
    j.remove(np.arange(1, 1500, 4))
    j.nprobe_hint = 4
    t = carry(j, tmesh, **kw)
    t.add(clustered(4, 1500))
    t.remove(np.arange(1, 1500, 4))
    t.nprobe_hint = 4
    queries = clustered(6, 3)
    want = t.search(queries, 10, nprobe=3)
    j.save(str(tmp_path / "jax.idx"))
    t.save(str(tmp_path / "port.idx"))
    for path in ("jax.idx", "port.idx"):
        back_j = JaxSharded.load(str(tmp_path / path), jmesh)
        back_t = ShardedIVFIndex.load(str(tmp_path / path), tmesh)
        assert back_t.nprobe_hint == back_j.nprobe_hint == 4
        assert_same_layout(back_j, back_t)
        one_t = IVFIndex.load(str(tmp_path / path), device="cpu")
        one_j = JaxIVF.load(str(tmp_path / path))
        assert one_t._refine is None or one_t._refine.count == 1500
        for index in (back_t, one_t):
            got = index.search(queries, 10, nprobe=3)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        assert_close(back_j.search(queries, 10, nprobe=3), want, 1e-4)
        assert_close(one_j.search(queries, 10, nprobe=3), want, 1e-4)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_ties_go_to_the_lower_shard(dtype, meshes):
    """16 copies of one row water-fill 2 a shard; a search at k 6 ties all
    of them and answers shard 0's two, then shard 1's, then shard 2's, in
    both packages."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(9)
    base = clustered(8, 64)
    row = base[:1]
    j = JaxSharded(D, jmesh, dtype=dtype, nlist=4, seed=3)
    j.add(base)
    t = carry(j, tmesh, dtype=dtype)
    t.add(base)
    dup = np.repeat(row, 16, axis=0)
    j.add(dup)
    t.add(dup)
    assert_same_layout(j, t)
    q = (row + 0.01 * rng.standard_normal(row.shape)).astype(np.float32)
    gs, gi = t.search(q, 6, nprobe=4)
    js, ji = j.search(q, 6, nprobe=4)
    cluster = int(t._slot_cluster[64])
    slots = t._slot_pos[64:80] // t._local_capacity
    assert sorted(np.bincount(slots, minlength=S)) == [2] * S
    dup_ids = [i for i in gi[0] if i >= 64]
    assert len(dup_ids) == len(gi[0]) - (gi[0] < 64).sum()
    shards = t._slot_pos[dup_ids] // t._local_capacity
    assert (np.diff(shards) >= 0).all(), shards
    assert (t._slot_cluster[dup_ids] == cluster).all()
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_allclose(gs, js, rtol=1e-5)
