"""The port's ``ShardedFlatIndex`` (``tpu_search_torch/parallel/``) on the
CPU, over 8 shards that share the host (the port's ``build_mesh`` over
the 8 devices ``XLA_FLAGS`` gives the JAX package's CPU mesh):

- the cases of ``tests/test_parallel.py``'s ``TestShardedIndex``,
  ``TestShardedInt4``, ``TestShardedInt8``, ``TestShardedL2`` and
  ``TestShardedAdoption`` on the port (collected from their source with
  ``tpu_search.`` pointed at ``tpu_search_torch.``, ``jnp.asarray`` at
  ``torch.as_tensor``, without their ``slow`` mark).  Left out:
  ``TestShardedEncode``, ``TestTrainStep`` and ``TestTrainCheckpoint``
  (data-parallel encode and the training step, not ported yet), and
  ``TestShardedPallasLocalScan`` (it holds the JAX package's Pallas
  per-shard scan against its XLA one; the port has one per-shard scan,
  ``index.flat.flat_scan``).  ``test_incremental_appends_match_full_push``
  asserts that the JAX package's jitted scatter programs were built; here
  it asserts that an append within capacity writes the shards' buffers in
  place instead.  ``test_mask_over_global_ids`` reads the JAX index's one
  mask cache; the port's cache is each shard's penalty cache, so it reads
  those (a hit returns the same tensors, a write clears the written
  shard's);
- the JAX ``ShardedFlatIndex`` on its 8 virtual CPU devices and the
  port's on the same seeded rows, in every dtype and metric, with masks,
  tombstones, growth past the first local capacity and ``compact``:
  int8 / int4 scores equal, float scores within 1e-5 relative, ids equal;
- TPUSIDX2 files both ways: a JAX sharded save in the port's sharded and
  flat indexes, a port sharded save in the JAX flat and sharded indexes;
- the merge's tie rule on planted equal scores: a tie goes to the lower
  position of the shard-major concatenation (the lower shard, then the
  lower slot), as ``lax.top_k`` orders it, in both packages.
"""

import numpy as np
import pytest
import torch

from test_torch_pq_codec import port_cases
from tpu_search.index.flat import FlatIndex as JaxFlatIndex
from tpu_search.parallel import ShardedFlatIndex as JaxSharded
from tpu_search.parallel import build_mesh as jax_build_mesh
from tpu_search_torch.devices import platform_devices
from tpu_search_torch.index.flat import FlatIndex
from tpu_search_torch.parallel import ShardedFlatIndex, build_mesh
from tpu_search_torch.parallel.sharded_index import merge_shards


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The port's indexes default to the CPU here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def mesh8():
    devices = platform_devices("cpu")
    assert len(devices) == 8, "conftest's XLA_FLAGS must give 8 devices"
    return build_mesh(n_data=8, devices=devices)


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_build_mesh(n_data=8)


_PARALLEL = port_cases(
    "test_parallel",
    replace=(
        ("from tpu_search_torch.models.mpnet import MPNetConfig, encode, "
         "init_params", "from tpu_search_torch.models.mpnet import "
         "MPNetConfig"),
        ("    init_train_state,\n    make_sharded_encode,\n"
         "    make_train_step,\n    shard_params,\n", ""),
        ("jnp.asarray(", "torch.as_tensor("),
    ),
    drop=("mesh8", "mesh4x2", "TestShardedEncode", "TestTrainStep",
          "TestTrainCheckpoint", "TestShardedPallasLocalScan"),
)
globals().update({k: v for k, v in _PARALLEL.items()
                  if k.startswith("TestSharded")})
normed = _PARALLEL["normed"]


class TestShardedIndex(_PARALLEL["TestShardedIndex"]):
    def test_incremental_appends_match_full_push(self, mesh8):
        """Appends within capacity write each shard's buffers in place (no
        corpus re-upload) and are indistinguishable from a rebuilt index;
        removals tombstone in place too."""
        rng = np.random.default_rng(3)
        d = 32
        first, second, third = (
            normed(rng, 500, d), normed(rng, 37, d), normed(rng, 1, d)
        )
        queries = normed(rng, 4, d)

        sharded = ShardedFlatIndex(dim=d, mesh=mesh8, dtype="float32")
        sharded.add(first)
        _, before = sharded.make_scan_fn()
        ids2 = sharded.add(second)
        sharded.add(third)
        assert sharded.remove([5, int(ids2[0])]) == 2
        _, after = sharded.make_scan_fn()
        assert [t.data_ptr() for t in before if t is not None] == [
            t.data_ptr() for t in after if t is not None]

        rebuilt = ShardedFlatIndex(dim=d, mesh=mesh8, dtype="float32")
        rebuilt.add(np.concatenate([first, second, third]))
        rebuilt.remove([5, int(ids2[0])])
        got_scores, got_ids = sharded.search(queries, k=12)
        ref_scores, ref_ids = rebuilt.search(queries, k=12)
        assert np.array_equal(got_ids, ref_ids)
        np.testing.assert_allclose(got_scores, ref_scores, rtol=1e-5)

    def test_mask_over_global_ids(self, mesh8):
        rng = np.random.default_rng(1)
        d = 16
        vecs = normed(rng, 300, d)
        sharded = ShardedFlatIndex(dim=d, mesh=mesh8, dtype="float32")
        sharded.add(vecs)
        mask = rng.random(300) < 0.2
        q = normed(rng, 2, d)
        _, ids = sharded.search(q, k=10, mask=mask)
        allowed = set(np.nonzero(mask)[0])
        for row in ids:
            assert all(i in allowed for i in row if i >= 0)

        def cached():
            return [len(sh._penalty_cache) for sh in sharded._shards.values()]

        # repeated filter hits each shard's device-side penalty cache...
        assert cached() == [1] * 8
        first = sharded.device_mask(mask)
        _, ids2 = sharded.search(q, k=10, mask=mask)
        assert np.array_equal(ids, ids2)
        assert cached() == [1] * 8
        assert all(a is b for a, b in zip(first, sharded.device_mask(mask)))
        # ...and a mutation invalidates the written shard's
        keep = ids[0][ids[0] >= 0]
        sharded.remove(keep[:1])
        assert cached()[int(keep[0]) % 8] == 0
        _, ids3 = sharded.search(q, k=10, mask=mask)
        assert keep[0] not in set(ids3[0].tolist())


# -- the port against the JAX package ------------------------------------------

CASES = [("float32", "ip"), ("bfloat16", "ip"), ("float32", "l2"),
         ("bfloat16", "l2"), ("int8", "ip"), ("int4", "ip")]


def rows_for(metric, rng, n, d):
    if metric == "l2":
        return rng.standard_normal((n, d)).astype(np.float32)
    return normed(rng, n, d)


def assert_same(got, want, dtype):
    """Scores equal (int8 / int4) or within 1e-5 relative (floats), ids
    equal."""
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape
    if dtype in ("int8", "int4"):
        np.testing.assert_array_equal(gs, ws)
    else:
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("dtype,metric", CASES)
def test_matches_the_jax_sharded_index(mesh8, jax_mesh8, dtype, metric):
    """Three appends (the last grows every shard past 1,024 slots), a
    tombstone batch, searches with and without a predicate mask, at k
    below and above the shard count, then ``compact``: the same answers
    and the same old -> new map in both packages."""
    rng = np.random.default_rng(7)
    d = 16
    batches = [rows_for(metric, rng, n, d) for n in (700, 333, 8000)]
    queries = rows_for(metric, rng, 5, d)
    port = ShardedFlatIndex(dim=d, mesh=mesh8, metric=metric, dtype=dtype)
    ref = JaxSharded(dim=d, mesh=jax_mesh8, metric=metric, dtype=dtype)
    for batch in batches:
        assert np.array_equal(port.add(batch), ref.add(batch))
    assert port.capacity == ref.capacity > 8 * 1024
    dead = rng.choice(port.ntotal, size=900, replace=False)
    assert port.remove(dead) == ref.remove(dead) == 900
    assert port.live == ref.live
    mask = rng.random(port.ntotal) < 0.3
    for k in (5, 40):
        assert_same(port.search(queries, k), ref.search(queries, k), dtype)
        assert_same(port.search(queries, k, mask=mask),
                    ref.search(queries, k, mask=mask), dtype)
    assert port.compact() == ref.compact()
    assert (port.ntotal, port.live, port.capacity) == (
        ref.ntotal, ref.live, ref.capacity)
    assert_same(port.search(queries, 10), ref.search(queries, 10), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_k_above_the_local_capacity_pads(mesh8, jax_mesh8, dtype):
    """``k_eff = min(k, local_capacity)``, then -inf / -1 padding."""
    rng = np.random.default_rng(8)
    vecs = normed(rng, 60, 8)
    port = ShardedFlatIndex(dim=8, mesh=mesh8, dtype=dtype)
    ref = JaxSharded(dim=8, mesh=jax_mesh8, dtype=dtype)
    port.add(vecs)
    ref.add(vecs)
    got, want = port.search(vecs[:2], 1100), ref.search(vecs[:2], 1100)
    assert_same(got, want, dtype)
    assert (got[1][:, 60:] == -1).all() and np.isneginf(got[0][:, 1024:]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_from_device_vectors_matches_jax(mesh8, jax_mesh8, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    vecs = normed(rng, 301, 16)
    port = ShardedFlatIndex.from_device_vectors(torch.as_tensor(vecs),
                                                mesh=mesh8, dtype=dtype)
    ref = JaxSharded.from_device_vectors(jnp.asarray(vecs), mesh=jax_mesh8,
                                         dtype=dtype)
    assert port.capacity == ref.capacity
    assert_same(port.search(vecs[:6], 7), ref.search(vecs[:6], 7), dtype)


# -- TPUSIDX2 files across the packages ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_jax_sharded_save_loads_in_the_port(mesh8, jax_mesh8, tmp_path,
                                            dtype):
    rng = np.random.default_rng(10)
    vecs = normed(rng, 151, 16)  # odd: a trailing int4 nibble
    ref = JaxSharded(dim=16, mesh=jax_mesh8, dtype=dtype)
    ref.add(vecs)
    ref.remove([3, 77])
    path = str(tmp_path / "jax_sharded.tpuidx")
    ref.save(path)
    want = ref.search(vecs[:4], 6)
    sharded = ShardedFlatIndex.load(path, mesh=mesh8)
    flat = FlatIndex.load(path, device="cpu")
    assert sharded.dtype == flat.dtype == dtype
    assert sharded.live == flat.live == 149
    assert_same(sharded.search(vecs[:4], 6), want, dtype)
    # one device against eight: the same rows, ties aside, the same answer
    assert_same(flat.search(vecs[:4], 6), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_port_sharded_save_loads_in_jax(mesh8, jax_mesh8, tmp_path, dtype):
    rng = np.random.default_rng(11)
    vecs = normed(rng, 151, 16)
    port = ShardedFlatIndex(dim=16, mesh=mesh8, dtype=dtype)
    port.add(vecs)
    port.remove([0, 150])
    path = str(tmp_path / "port_sharded.tpuidx")
    port.save(path)
    want = port.search(vecs[:4], 6)
    flat = JaxFlatIndex.load(path)
    sharded = JaxSharded.load(path, mesh=jax_mesh8)
    assert flat.dtype == sharded.dtype == dtype
    assert flat.live == sharded.live == 149
    assert_same(sharded.search(vecs[:4], 6), want, dtype)
    assert_same(flat.search(vecs[:4], 6), want, dtype)


@pytest.mark.parametrize("src,dst", [("int8", "float32"), ("int4", "bfloat16"),
                                     ("float32", "int8"), ("bfloat16", "int4")])
def test_cross_dtype_load_matches_jax(mesh8, jax_mesh8, tmp_path, src, dst):
    """``load(dtype=...)`` dequantizes, casts or quantizes as the JAX
    package does: the same answers, bit for bit where quantized."""
    rng = np.random.default_rng(12)
    vecs = normed(rng, 90, 16)
    ref = JaxSharded(dim=16, mesh=jax_mesh8, dtype=src)
    ref.add(vecs)
    path = str(tmp_path / "x.tpuidx")
    ref.save(path)
    port = ShardedFlatIndex.load(path, mesh=mesh8, dtype=dst)
    back = JaxSharded.load(path, mesh=jax_mesh8, dtype=dst)
    assert port.dtype == dst
    assert_same(port.search(vecs[:5], 4), back.search(vecs[:5], 4), dst)


# -- the merge's tie rule --------------------------------------------------------

def test_merge_keeps_the_lower_position_on_ties():
    """Equal scores keep their order in the shard-major concatenation, as
    ``lax.top_k`` over the same ``[Q, S * k]`` array orders them."""
    import jax

    scores = [torch.tensor([[0.5, 0.5, 0.1]]), torch.tensor([[0.75, 0.5, 0.5]]),
              torch.tensor([[0.5, 0.25, -float("inf")]])]
    local = [torch.tensor([[0, 2, 4]], dtype=torch.int32),
             torch.tensor([[0, 2, 4]], dtype=torch.int32),
             torch.tensor([[0, 2, -1]], dtype=torch.int32)]
    top, got = merge_shards(scores, local, 7, 3)
    # global id = local * 3 + shard; -1 stays -1
    assert got.tolist() == [[1, 0, 6, 7, 13, 2, 8]]
    assert top[0, :6].tolist() == [0.75, 0.5, 0.5, 0.5, 0.5, 0.5]
    cat = np.concatenate([s.numpy() for s in scores], axis=1)
    want_s, pos = jax.lax.top_k(cat, 7)
    cat_ids = np.concatenate([(i.numpy() * 3 + s) for s, i in
                              enumerate(local)], axis=1)
    assert got.tolist() == np.take_along_axis(cat_ids, np.asarray(pos),
                                              axis=1).tolist()
    np.testing.assert_array_equal(top.numpy(), np.asarray(want_s))
    _, last = merge_shards(scores, local, 9, 3)
    assert last[0, -1] == -1  # the -inf slot keeps id -1


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_planted_ties_follow_the_jax_order(mesh8, jax_mesh8, dtype):
    """One row planted at global ids 3, 10, 17 (shards 3, 2, 1) and 9
    (shard 1, the slot after 1): both packages return 1, 9, 17, 10, 3,
    lower shard first, then lower slot, where a single device would
    order them by id."""
    rng = np.random.default_rng(13)
    vecs = normed(rng, 24, 16)
    for g in (3, 9, 10, 17):
        vecs[g] = vecs[1]
    port = ShardedFlatIndex(dim=16, mesh=mesh8, dtype=dtype)
    ref = JaxSharded(dim=16, mesh=jax_mesh8, dtype=dtype)
    port.add(vecs)
    ref.add(vecs)
    got, want = port.search(vecs[1], 5), ref.search(vecs[1], 5)
    assert_same(got, want, dtype)
    assert got[1][0].tolist() == [1, 9, 17, 10, 3]
    assert len(set(got[0][0].tolist())) == 1


# -- buffers, growth and the mask cache ------------------------------------------

def test_growth_moves_every_shard_and_clears_the_mask_cache(mesh8):
    """A fused program keys on every shard's buffers: adds and removes
    within capacity keep them in place, a growth (every shard at once)
    moves all of them.  The mask cache is each shard's penalty cache: a
    write clears the caches of the shards it wrote, a growth every
    shard's, also of shards that took no row of the add."""
    rng = np.random.default_rng(14)
    index = ShardedFlatIndex(dim=16, mesh=mesh8, dtype="int8")
    index.add(normed(rng, 100, 16))

    def addresses():
        return [t.data_ptr() for t in index.make_scan_fn()[1]]

    def cached():
        return [len(sh._penalty_cache) for sh in index._shards.values()]

    mask = rng.random(100) < 0.5
    before = addresses()
    index.device_mask(mask)
    assert cached() == [1] * 8
    index.add(normed(rng, 50, 16))
    assert cached() == [0] * 8
    index.device_mask(mask)
    index.remove([3, 4])
    assert cached() == [1, 1, 1, 0, 0, 1, 1, 1] and addresses() == before
    # The last count that fits 1,024 local slots (int8 keeps 8 spare),
    # then one row, to shard 0, grows all 8.
    index.add(normed(rng, 8 * 1016 - 150, 16))
    assert index._local_capacity == 1024
    index.device_mask(None)
    index.device_mask(mask)
    assert cached() == [2] * 8
    index.add(normed(rng, 1, 16))
    after = addresses()
    assert index._local_capacity == 2048
    assert all(a != b for a, b in zip(after, before))
    assert cached() == [0] * 8


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_search_after_a_one_row_growth(mesh8, dtype):
    """An unfiltered and a filtered search, then one row that grows every
    shard while 7 shards take no row: the next searches see every shard
    at its new capacity and answer as one ``FlatIndex`` does."""
    rng = np.random.default_rng(17)
    fill = 8 * (1024 - {"int8": 8, "int4": 16}.get(dtype, 0))
    vecs = normed(rng, fill + 1, 16)
    index = ShardedFlatIndex(dim=16, mesh=mesh8, dtype=dtype)
    flat = FlatIndex(16, dtype=dtype, device="cpu")
    index.add(vecs[:fill])
    flat.add(vecs[:fill])
    mask = rng.random(fill + 1) < 0.5
    index.search(vecs[:3], 5)
    index.search(vecs[:3], 5, mask=mask)
    index.add(vecs[fill:])
    flat.add(vecs[fill:])
    assert index._local_capacity == 2048
    queries = np.concatenate([vecs[:3], vecs[-1:]])
    assert_same(index.search(queries, 5), flat.search(queries, 5), dtype)
    assert_same(index.search(queries, 5, mask=mask),
                flat.search(queries, 5, mask=mask), dtype)


def test_mask_cache_under_concurrent_searches(mesh8):
    """16 threads (more than the host's cores) asking for 12 masks, more
    than the shards' caches hold, with a short switch interval: each gets
    its own mask's penalties, and no shard's cache exceeds its bound."""
    import sys
    import threading

    rng = np.random.default_rng(15)
    index = ShardedFlatIndex(dim=16, mesh=mesh8, dtype="float32")
    vecs = normed(rng, 400, 16)
    index.add(vecs)
    masks = [rng.random(400) < 0.5 for _ in range(12)]
    want = [index.search(vecs[:2], 5, mask=m) for m in masks]
    wrong, sizes = [], []
    start = threading.Barrier(16)

    def client(c):
        start.wait(timeout=60)
        for r in range(30):
            i = (c + r) % len(masks)
            got = index.search(vecs[:2], 5, mask=masks[i])
            if not (np.array_equal(got[1], want[i][1])
                    and np.array_equal(got[0], want[i][0])):
                wrong.append((c, i))
            sizes.append(max(len(sh._penalty_cache)
                             for sh in index._shards.values()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == [] and len(sizes) == 16 * 30 and max(sizes) <= 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_round1_npz_loads_sharded(mesh8, tmp_path, dtype):
    """A round-1 npz file (f32 rows, the header's dtype) loads sharded as
    the port's ``FlatIndex`` loads it: the rows re-added in the dtype."""
    import json

    rng = np.random.default_rng(16)
    vecs = normed(rng, 37, 24)
    valid = np.ones(37, np.bool_)
    valid[[3, 20]] = False
    path = tmp_path / "embeddings.tpuidx.npz"
    with open(path, "wb") as f:
        np.savez(f, header=json.dumps({"kind": "flat", "dim": 24,
                                       "metric": "ip", "dtype": dtype,
                                       "count": 37}),
                 vectors=vecs, valid=valid)
    sharded = ShardedFlatIndex.load(str(path), mesh=mesh8)
    flat = FlatIndex.load(str(path), device="cpu")
    assert sharded.dtype == dtype and (sharded.ntotal, sharded.live) == (37, 35)
    assert_same(sharded.search(vecs[:5], 4), flat.search(vecs[:5], 4), dtype)


# -- the device of each shard's launch -------------------------------------------

class _OnDevice:
    """A stand-in for a tensor on ``device``: what ``sharded_scan`` reads
    of its buffers and queries (``value`` is what ``to`` gives back)."""

    def __init__(self, device, value=None):
        self.device = torch.device(device)
        self.value = value

    def to(self, device):
        return self if self.value is None else self.value


def test_each_shard_scans_with_its_card_current(monkeypatch):
    """Shards on cuda:0 and cuda:1: each shard's scan is called with its
    own card the current device (a wrapper launches on that card's
    stream, which CUDA runs only from the card), and the current device
    is the caller's again afterwards."""
    from tpu_search_torch.parallel import sharded_index

    current = ["cuda:0"]

    class FakeDevice:
        def __init__(self, device):
            self.device = str(torch.device(device))

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    seen = []

    def fake_scan(key, buffers, staged, queries, k, rows):
        seen.append((str(buffers[0].device), current[-1]))
        shard = int(str(buffers[0].device)[-1])
        scores = torch.tensor([[2.0 - shard, 0.5]])
        return (_OnDevice(buffers[0].device, scores),
                _OnDevice(buffers[0].device, torch.tensor([[0, 1]])))

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(sharded_index, "flat_scan", fake_scan)
    mesh = build_mesh(n_data=2, devices=["cuda:0", "cuda:1"])
    key = ("sharded_flat", mesh, "float32", "ip", (0, 1), False)
    buffers = (_OnDevice("cuda:0"), None, _OnDevice("cuda:1"), None)
    scores, ids = sharded_index.sharded_scan(key, buffers, (None, None),
                                             _OnDevice("cuda:0"), 2)
    assert seen == [("cuda:0", "cuda:0"), ("cuda:1", "cuda:1")]
    assert current == ["cuda:0"]
    assert scores.tolist() == [[2.0, 1.0]] and ids.tolist() == [[0, 1]]


def test_colocated_reads_cuda_as_the_current_device(monkeypatch):
    """``colocated(cuda)`` compares the shards' cards with the current
    CUDA device, not with ordinal 0 (no tensor is made: the shards are
    empty)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    on_one = ShardedFlatIndex(dim=8, mesh=build_mesh(
        n_data=2, devices=["cuda:1", "cuda:1"]))
    on_zero = ShardedFlatIndex(dim=8, mesh=build_mesh(
        n_data=2, devices=["cuda:0", "cuda:0"]))
    split = ShardedFlatIndex(dim=8, mesh=build_mesh(
        n_data=2, devices=["cuda:0", "cuda:1"]))
    cuda = torch.device("cuda")
    assert on_one.colocated(cuda) and on_one.colocated("cuda:1")
    assert not on_zero.colocated(cuda) and on_zero.colocated("cuda:0")
    assert not split.colocated(cuda) and not split.colocated("cuda:0")
