"""The port's storage calls that serve the CLI's and the MCP server's
SQL-only reads and the maintenance paths, against the JAX package's on
one data directory (one SQLite schema, one TPUSIDX2 format):

- ``initialize_metadata``, ``_matches_filters``, ``get_chunks_by_session``,
  ``get_chunks_by_project``, ``delete_chunk``, ``delete_chunks_by_session``,
  ``backup`` and ``restore``, each equal to ``tpu_search``'s;
- a delete seen by the port's fused search at once (``_data_version``);
- a backup written by either package restored by the other;
- round-1 npz index files (flat float32 / bfloat16 / int8 / int4, IVF
  float32 / bfloat16), written as the JAX package's ``_load_legacy_npz``
  reads them, loading in both packages with equal rows, codes and scales
  bit for bit.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import write_model
from test_torch_flat_index_quant import stored
from test_torch_host_copies import write_transcripts
from tpu_search.index.registry import load_index as jax_load_index
from tpu_search.storage.hybrid import HybridStorage as JaxHybridStorage
from tpu_search.storage.hybrid import StorageConfig as JaxStorageConfig
from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.index.registry import load_index
from tpu_search_torch.interfaces import cli as port_cli
from tpu_search_torch.storage.hybrid import HybridStorage, StorageConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A data directory indexed by the port (``hash-768``, bf16 flat)."""
    root = tmp_path_factory.mktemp("storage_calls")
    write_transcripts(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
        port_cli.main(["--data-dir", str(root / "data"), "--device", "cpu",
                       "index", "--claude-dir",
                       str(root / "claude-projects")])
    return root / "data"


def _copy(corpus, dest):
    shutil.copytree(corpus, dest)
    return dest


def _pair(port_dir, jax_dir):
    port = HybridStorage(StorageConfig(data_dir=str(port_dir), device="cpu",
                                       auto_save=False))
    ref = JaxHybridStorage(JaxStorageConfig(data_dir=str(jax_dir),
                                            device="cpu", auto_save=False))
    return port, ref


def _chunks(chunks):
    return [(c.id, c.text, c.metadata) for c in chunks]


def _state(storage):
    """``(chunk id -> slot, live slots, bf16 rows of the live slots)``."""
    index = storage.index
    valid = np.asarray(index._valid[: index.ntotal], dtype=bool)
    rows = index._vectors[: index.ntotal]
    rows = (rows.view(torch.int16).numpy() if isinstance(rows, torch.Tensor)
            else np.asarray(rows).view(np.int16))
    return (dict(storage.chunk_id_to_faiss_id), np.flatnonzero(valid),
            rows[valid])


def test_metadata_reads_equal(corpus):
    port, ref = _pair(corpus, corpus)
    port.initialize_metadata()
    ref.initialize_metadata()
    assert port.index is None  # SQLite only
    assert port.get_all_projects() == ref.get_all_projects()
    for session in ("s1", "s2", "s3", "none"):
        assert _chunks(port.get_chunks_by_session(session)) == _chunks(
            ref.get_chunks_by_session(session))
    for project in ("-root-myproj", "-root-other", "none"):
        assert _chunks(port.get_chunks_by_project(project)) == _chunks(
            ref.get_chunks_by_project(project))
    assert port.get_chunks_by_session("s1")
    row = port._get_chunk_data("chunk_000002")
    for spec in ({"project_name": "myproj"}, {"project_name": "nope"},
                 {"has_code": True}, {"session_id": row["session_id"]},
                 {"timestamp": {"gte": "2025-07-02T00:00:00+00:00"}}):
        assert port._matches_filters(row, spec) == ref._matches_filters(
            row, spec)


@pytest.mark.parametrize("call,arg", [
    ("delete_chunk", "chunk_000002"),
    ("delete_chunk", "no-such-chunk"),
    ("delete_chunks_by_session", "s2"),
    ("delete_chunks_by_session", "no-such-session"),
])
def test_deletes_equal(corpus, tmp_path, call, arg):
    port, ref = _pair(_copy(corpus, tmp_path / "port"),
                      _copy(corpus, tmp_path / "jax"))
    port.initialize()
    ref.initialize()
    version = port._data_version
    got, want = getattr(port, call)(arg), getattr(ref, call)(arg)
    assert got == want
    assert (port._data_version > version) == bool(got)
    assert port.total_chunks == ref.total_chunks
    p_map, p_live, p_rows = _state(port)
    j_map, j_live, j_rows = _state(ref)
    assert p_map == j_map
    np.testing.assert_array_equal(p_live, j_live)
    np.testing.assert_array_equal(p_rows, j_rows)
    assert port.meta.stats() == ref.meta.stats()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_backup_restores_in_the_other_package(corpus, tmp_path, writer):
    """A backup made by ``writer`` restores into the other package's
    storage on a fresh directory; both hold the source's rows and maps."""
    source_port, source_jax = _pair(corpus, corpus)
    source = source_port if writer == "port" else source_jax
    source.initialize()
    source.backup(str(tmp_path / "backup"))
    assert sorted(p.name for p in (tmp_path / "backup").iterdir()) == [
        "embeddings.tpuidx.npz", "metadata.db"]
    port, ref = _pair(tmp_path / "port", tmp_path / "jax")
    target = ref if writer == "port" else port
    target.initialize()
    target.restore(str(tmp_path / "backup"))
    if target is port:
        assert port.index.device == CPU
    got, want = _state(target), _state(source)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert target.meta.stats() == source.meta.stats()
    assert _chunks(target.get_chunks_by_session("s1")) == _chunks(
        source.get_chunks_by_session("s1"))


def test_restore_bumps_the_data_version(corpus, tmp_path):
    port, _ = _pair(_copy(corpus, tmp_path / "port"), corpus)
    port.initialize()
    port.backup(str(tmp_path / "backup"))
    version = port._data_version
    port.restore(str(tmp_path / "backup"))
    assert port._data_version > version


def test_deletes_seen_by_the_fused_search(tmp_path):
    """``delete_chunk`` and ``delete_chunks_by_session`` on a live engine:
    the next fused search (the tiny checkpoint on the CPU) no longer
    returns the deleted chunks."""
    write_transcripts(tmp_path)
    write_model(tmp_path / "data" / "models")
    engine = SearchEngine(str(tmp_path / "data"), model_name="tiny-mpnet",
                          use_warm_server=False, device="cpu")
    engine.index_conversations(
        sorted((tmp_path / "claude-projects").rglob("*.jsonl")))
    storage = engine.storage
    text = storage.get_chunk_by_id("chunk_000002").text
    assert engine._fused_search_many([text], None, _cfg()) is not None

    def ids():
        return [r["chunk_id"] for r in engine.search_conversations(
            text, top_k=50)]

    before = ids()
    assert before[0] == "chunk_000002"
    assert storage.delete_chunk("chunk_000002")
    after = ids()
    assert "chunk_000002" not in after
    assert after == [c for c in before if c != "chunk_000002"]
    session = storage._get_chunk_data(after[0])["session_id"]
    assert storage.delete_chunks_by_session(session) > 0
    left = engine.search_conversations(text, top_k=50)
    assert left and all(r["session"] != session for r in left)


def _cfg():
    from tpu_search_torch.storage.hybrid import SearchConfig

    return SearchConfig(top_k=10)


# -- round-1 npz index files ----------------------------------------------


def _rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _write_npz(path, **arrays):
    with open(path, "wb") as f:  # no ".npz" appended to the name
        np.savez(f, **arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_round1_flat_loads_alike(tmp_path, dtype):
    count, dim = 37, 24
    vectors = _rows(count, dim, 1)
    valid = np.ones(count, np.bool_)
    valid[[3, 20]] = False
    path = tmp_path / "embeddings.tpuidx.npz"
    _write_npz(path, header=json.dumps({"kind": "flat", "dim": dim,
                                        "metric": "ip", "dtype": dtype,
                                        "count": count}),
               vectors=vectors, valid=valid)
    port = load_index(str(path), device=CPU)
    ref = jax_load_index(str(path), device=jax.devices("cpu")[0])
    assert (port.ntotal, port.live, port.dtype) == (count, count - 2, dtype)
    assert (ref.ntotal, ref.live) == (port.ntotal, port.live)
    np.testing.assert_array_equal(port._valid[:count].numpy(), valid)
    if dtype in ("int8", "int4"):
        got_rows, got_scales = stored(port, count)
        want_rows, want_scales = stored(ref, count)
        np.testing.assert_array_equal(got_rows, want_rows)
        assert got_scales.tobytes() == want_scales.tobytes()
    else:
        got = port._vectors[:count]
        want = np.asarray(ref._vectors[:count])
        if dtype == "bfloat16":
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got = got.numpy()
        assert got.tobytes() == want.tobytes()
    scores, ids = port.search(vectors[:4], k=3)
    assert ids[0, 0] == 0 and 3 not in ids[3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round1_ivf_loads_alike(tmp_path, dtype):
    """The hand-built round-1 IVF file of ``tests/test_index_ivf.py``."""
    nlist, cap, dim = 2, 64, 8
    rows = _rows(6, dim, 9)
    vectors = np.zeros((nlist, cap, dim), np.float32)
    ids = np.full((nlist, cap), -1, np.int32)
    valid = np.zeros((nlist, cap), np.bool_)
    for g in range(6):
        c, p = g % 2, g // 2
        vectors[c, p], ids[c, p], valid[c, p] = rows[g], g, True
    valid[1, 2] = False  # tombstone id 5
    path = tmp_path / "embeddings.tpuidx.npz"
    _write_npz(path, header=json.dumps({
        "kind": "ivf", "dim": dim, "metric": "ip", "dtype": dtype,
        "nlist": nlist, "count": 6, "cluster_capacity": cap}),
        centroids=_rows(nlist, dim, 10), vectors=vectors, ids=ids,
        valid=valid, fill=np.array([3, 3], np.int32))
    port = load_index(str(path), device=CPU)
    ref = jax_load_index(str(path), device=jax.devices("cpu")[0])
    assert type(port).__name__ == "IVFIndex"
    assert (port.ntotal, port.live) == (ref.ntotal, ref.live) == (6, 5)
    got = port._dblocks
    want = np.asarray(ref._dblocks)
    if dtype == "bfloat16":
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(port._dids.numpy(), np.asarray(ref._dids))
    np.testing.assert_array_equal(port._dvalid.numpy(),
                                  np.asarray(ref._dvalid))
    _, top = port.search(rows[2], k=1, nprobe=2)
    assert top[0, 0] == 2
    _, all5 = port.search(rows[5], k=6, nprobe=2)
    assert 5 not in set(all5.ravel())


def test_round1_ivf_refuses_quantized_rows(tmp_path):
    path = tmp_path / "embeddings.tpuidx.npz"
    _write_npz(path, header=json.dumps({
        "kind": "ivf", "dim": 8, "metric": "ip", "dtype": "int8",
        "nlist": 1, "count": 0, "cluster_capacity": 0}),
        centroids=np.zeros((0, 8), np.float32),
        vectors=np.zeros((1, 0, 8), np.float32),
        ids=np.zeros((1, 0), np.int32), valid=np.zeros((1, 0), np.bool_),
        fill=np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="float rows"):
        load_index(str(path), device=CPU)
