"""The port's sharded bulk build (``ShardedFlatIndex.from_device_vectors``)
against the JAX package's, on the CPU: 4 shards (the JAX side on 4 of the
8 XLA host devices ``tests/conftest.py`` gives, the port's on a repeated
CPU device), the same numpy rows in every dtype, from f32 and bf16
sources:

- local capacity, ``ntotal`` and ``live`` equal, and each shard's stored
  codes and scales in its live slots bit for bit, and its validity over
  the whole local capacity; int8 and int4 also with fewer rows than
  shards (3 rows on 4), where a shard holds none;
- merged answers equal (ids; scores within 1e-6), with and without a
  mask, after a remove and after an add;
- a TPUSIDX2 save of either package (global order) loads in the other
  with the same answers, and the two files hold the same bytes;
- in a group of two gloo processes of 4 CPU devices each
  (``build_mesh(n_data=8, dcn_data=2)``), each process builds only its own
  4 shards, to the bits and answers of one process holding all 8, and
  its per-process save loads back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.ops.int4_pack import unpack_int4_rows_host
from tpu_search.ops.int8_pack import unpack_int8_rows_host
from tpu_search.parallel import ShardedFlatIndex as JaxSharded
from tpu_search.parallel import build_mesh as jax_build_mesh
from test_torch_distributed import run_workers
from tpu_search_torch.ops.int4_pack import bytes_to_nibble_rows
from tpu_search_torch.ops.int8_pack import unpack_int8_rows
from tpu_search_torch.parallel import ShardedFlatIndex, build_mesh

S = 4
SCORE_TOL = 1e-6
# (storage dtype, source dtype, N, D)
CASES = [("float32", "f32", 3001, 32), ("bfloat16", "f32", 3001, 32),
         ("bfloat16", "bf16", 4096, 32), ("int8", "f32", 3001, 32),
         ("int8", "bf16", 2999, 32), ("int4", "f32", 3001, 32),
         ("int4", "bf16", 4093, 32), ("int8", "f32", 3, 32),
         ("int4", "f32", 3, 32)]
IDS = [f"{dtype}_from_{src}_{n}" for dtype, src, n, _ in CASES]


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def meshes():
    return (jax_build_mesh(n_data=S, devices=jax.devices()[:S]),
            build_mesh(n_data=S, devices=[torch.device("cpu")] * S))


def build(case, meshes):
    dtype, src, n, d = case
    rows = normed(np.random.default_rng(n), n, d)
    jv, tv = jnp.asarray(rows), torch.from_numpy(rows)
    if src == "bf16":
        jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    ref = JaxSharded.from_device_vectors(jv, mesh=meshes[0], dtype=dtype)
    port = ShardedFlatIndex.from_device_vectors(tv, mesh=meshes[1],
                                                dtype=dtype)
    return rows, ref, port


def jax_shard(ref, s):
    """Shard ``s`` of the JAX index: ``(codes or rows [local, D], scales,
    valid)`` as numpy."""
    v = np.asarray(ref._vectors)[s]
    if ref.dtype == "int8":
        v = unpack_int8_rows_host(v)
    elif ref.dtype == "int4":
        v = unpack_int4_rows_host(v).astype(np.uint8)
    elif ref.dtype == "bfloat16":
        v = v.view(np.uint16)
    sc = None if ref._scales is None else np.asarray(ref._scales)[s]
    return v, sc, np.asarray(ref._valid)[s]


def port_shard(port, s):
    shard = port._shards[s]
    v = shard._vectors
    if port.dtype == "int8":
        v = unpack_int8_rows(v)
    elif port.dtype == "int4":
        v = bytes_to_nibble_rows(v)
    elif port.dtype == "bfloat16":
        v = v.view(torch.int16)
    v = v.numpy()
    if port.dtype == "bfloat16":
        v = v.view(np.uint16)
    sc = None if shard._scales is None else shard._scales.numpy()
    return v, sc, shard._valid.numpy()


def assert_same_search(ref, port, queries, k=10, mask=None):
    sr, ir = ref.search(queries, k, mask=mask)
    sp, ip = port.search(queries, k, mask=mask)
    np.testing.assert_array_equal(ip, ir)
    np.testing.assert_allclose(sp, sr, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_adoption_matches_jax(case, meshes, tmp_path):
    rows, ref, port = build(case, meshes)
    assert (port._local_capacity, port.capacity, port.ntotal, port.live) == (
        ref._local_capacity, ref.capacity, ref.ntotal, ref.live)
    for s in range(S):
        (pv, ps, pm), (rv, rs, rm) = port_shard(port, s), jax_shard(ref, s)
        live = port._local_count(s)
        assert pv.shape == rv.shape
        np.testing.assert_array_equal(pv[:live], rv[:live].astype(pv.dtype))
        np.testing.assert_array_equal(pm, rm)
        if rs is None:
            assert ps is None
        else:
            np.testing.assert_array_equal(ps[:live].view(np.uint32),
                                          rs[:live].view(np.uint32))
    rng = np.random.default_rng(1)
    queries = np.concatenate([rows[:3], normed(rng, 3, rows.shape[1])])
    assert_same_search(ref, port, queries)
    mask = rng.random(port.ntotal) < 0.5
    assert_same_search(ref, port, queries, mask=mask)

    paths = str(tmp_path / "port.idx"), str(tmp_path / "jax.idx")
    port.save(paths[0])
    ref.save(paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    loaded = (JaxSharded.load(paths[0], mesh=meshes[0]),
              ShardedFlatIndex.load(paths[1], mesh=meshes[1]))
    assert_same_search(*loaded, queries)
    assert_same_search(ref, loaded[1], queries)

    gone = sorted({0, 6, 7, port.ntotal - 1})
    assert port.remove(gone) == ref.remove(gone) == len(
        [g for g in gone if g < port.ntotal])
    more = normed(rng, 30, rows.shape[1])
    np.testing.assert_array_equal(port.add(more), ref.add(more))
    assert (port.ntotal, port.live) == (ref.ntotal, ref.live)
    assert_same_search(ref, port, np.concatenate([more[:2], queries]))


WORKER = r"""
import os, sys
import numpy as np
import torch

pid, rendezvous, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from tpu_search_torch.parallel import (
    ShardedFlatIndex, build_mesh, initialize_distributed)

initialize_distributed(coordinator_address=rendezvous, num_processes=2,
                       process_id=pid)
mesh = build_mesh(n_data=8, dcn_data=2)
local = build_mesh(n_data=8, devices=[torch.device("cpu")] * 8)
rng = np.random.default_rng(0)  # the same rows on both processes
vecs = rng.standard_normal((301, 32)).astype(np.float32)
vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
rows = torch.from_numpy(vecs)
for dtype in ("bfloat16", "int8", "int4"):
    index = ShardedFlatIndex.from_device_vectors(rows, mesh=mesh, dtype=dtype)
    ref = ShardedFlatIndex.from_device_vectors(rows, mesh=local, dtype=dtype)
    assert sorted(index._shards) == list(range(4 * pid, 4 * pid + 4))
    for s, shard in index._shards.items():
        other = ref._shards[s]
        assert torch.equal(shard._vectors, other._vectors), (dtype, s)
        assert torch.equal(shard._valid, other._valid), (dtype, s)
        if dtype != "bfloat16":
            assert torch.equal(shard._scales, other._scales), (dtype, s)
    assert index.live == ref.live == 301 and index.capacity == ref.capacity
    got, want = index.search(vecs[:3], k=5), ref.search(vecs[:3], k=5)
    assert np.array_equal(got[1], want[1]), (dtype, got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    path = os.path.join(out_dir, f"adopt_{dtype}.tpuidx")
    index.save(path)
    loaded = ShardedFlatIndex.load(path, mesh=mesh).search(vecs[:3], k=5)
    assert np.array_equal(loaded[1], want[1]), dtype
torch.distributed.destroy_process_group()
print(f"ADOPT_WORKER_{pid}_OK", flush=True)
"""


def test_two_processes_adopt_their_own_shards(tmp_path):
    outs = run_workers(tmp_path, WORKER, "adopt_worker.py")
    for pid, out in enumerate(outs):
        assert f"ADOPT_WORKER_{pid}_OK" in out
