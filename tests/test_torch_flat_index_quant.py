"""The port's int8 / int4 flat tiers against the JAX package's, from the
index up through ``HybridStorage`` and ``SearchEngine``.

Tolerances: given the same vectors, the port's index stores the JAX
index's rows and scales bit for bit (the JAX buffers are word-packed, so
they are unpacked first) and searches to the same ids and bit-identical
scores, through adds from numpy and from tensors, removes, masks,
compaction, k = 200 and k past the capacity; TPUSIDX2 files load across
the packages both ways.  The engines embed with the same tiny checkpoint
in bf16 on each framework (embedding cosine > 0.999), so there results
agree up to near-ties: similarities within 5e-3 (int8) and 2e-2 (int4:
a small embedding difference can move a 4-bit code, ~1/7 of a row's max
component).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import QUERIES, write_model
from test_torch_host_copies import write_transcripts
from tpu_search.api.engine import SearchEngine as JaxSearchEngine
from tpu_search.index.flat import FlatIndex as JaxFlatIndex
from tpu_search.ingest.chunker import Chunk as JaxChunk
from tpu_search.ops.int4_pack import unpack_int4_rows_host
from tpu_search.ops.int8_pack import unpack_int8_rows_host
from tpu_search.storage.hybrid import HybridStorage as JaxHybridStorage
from tpu_search.storage.hybrid import SearchConfig as JaxSearchConfig
from tpu_search.storage.hybrid import StorageConfig as JaxStorageConfig
from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.index.flat import FlatIndex
from tpu_search_torch.ingest.chunker import Chunk
from tpu_search_torch.ops.int4_pack import bytes_to_nibble_rows
from tpu_search_torch.storage.hybrid import (
    HybridStorage,
    SearchConfig,
    StorageConfig,
)

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
QUANT = ["int8", "int4"]


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def pair(dtype, d=128):
    return (JaxFlatIndex(d, dtype=dtype, device=jax.devices("cpu")[0]),
            FlatIndex(d, dtype=dtype, device=CPU))


def stored(index, count):
    """``(rows [count, D] of codes, scales [count])`` of either package."""
    if isinstance(index, JaxFlatIndex):
        unpack = (unpack_int8_rows_host if index.dtype == "int8"
                  else unpack_int4_rows_host)
        rows = unpack(np.asarray(index._vectors))
        scales = np.asarray(index._scales)
    else:
        rows = index._vectors
        if index.dtype == "int4":
            rows = bytes_to_nibble_rows(rows)
        rows, scales = rows.numpy(), index._scales.numpy()
    return rows[:count].astype(np.int16), scales[:count]


def assert_same_search(a, b, queries, k, mask=None):
    sa, ia = a.search(queries, k, mask=mask)
    sb, ib = b.search(queries, k, mask=mask)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_array_equal(sb, sa)
    return sb, ib


@pytest.mark.parametrize("dtype", QUANT)
def test_stored_rows_and_scales_match_jax(dtype):
    """Host (numpy) and device (tensor / jax.Array) adds store the same
    bits in both packages, at unaligned starts."""
    rng = np.random.default_rng(0)
    jx, pt = pair(dtype)
    for n, on_device in ((301, False), (77, True), (650, False), (5, True)):
        batch = normed(rng, n, 128) * rng.uniform(0.1, 3.0)
        batch[0] = 0.0  # the 1e-12 scale floor
        if on_device:
            padded = np.zeros((n + 11, 128), np.float32)
            padded[:n] = batch
            jids = jx.add(jax.numpy.asarray(padded), n=n)
            pids = pt.add(torch.from_numpy(padded), n=n)
        else:
            jids, pids = jx.add(batch), pt.add(batch)
        np.testing.assert_array_equal(pids, jids)
    count = jx.ntotal
    assert pt.ntotal == count == 1033
    for a, b in zip(stored(jx, count), stored(pt, count)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dtype", QUANT)
def test_lifecycle_matches_jax(dtype):
    rng = np.random.default_rng(1)
    jx, pt = pair(dtype)
    for batch in (normed(rng, 700, 128), normed(rng, 900, 128)):
        np.testing.assert_array_equal(pt.add(batch),
                                      jx.add(torch.from_numpy(batch).numpy()))
    queries = normed(rng, 5, 128)
    for k in (10, 128, 200, 5000):  # 200: past the in-kernel k; 5000: > cap
        scores, ids = assert_same_search(jx, pt, queries, k)
        assert scores.shape == (5, k)
    assert (ids[:, 1600:] == -1).all() and np.isneginf(scores[:, 1600:]).all()

    gone = rng.choice(1600, size=300, replace=False)
    assert pt.remove(gone) == jx.remove(gone) == 300
    assert pt.live == jx.live == 1300
    mask = rng.random(1600) < 0.5
    _, ids = assert_same_search(jx, pt, queries, 20, mask=mask)
    assert not np.isin(ids[ids >= 0], gone).any()
    assert_same_search(jx, pt, queries, 200, mask=mask)

    assert pt.compact() == jx.compact()
    assert pt.ntotal == pt.live == 1300
    for a, b in zip(stored(jx, 1300), stored(pt, 1300)):
        np.testing.assert_array_equal(b, a)
    assert_same_search(jx, pt, queries, 128)


@pytest.mark.parametrize("count", [1500, 1501])
@pytest.mark.parametrize("dtype", QUANT)
def test_tpusidx2_interop_both_ways(tmp_path, dtype, count):
    rng = np.random.default_rng(3)
    jx, pt = pair(dtype)
    data = normed(rng, count, 128)
    jx.add(data)
    pt.add(data)
    gone = np.arange(0, count, 7)
    jx.remove(gone)
    pt.remove(gone)
    queries = normed(rng, 4, 128)

    jx.save(str(tmp_path / "jax.idx"))
    from_jax = FlatIndex.load(str(tmp_path / "jax.idx"), device=CPU)
    assert (from_jax.dtype, from_jax.ntotal, from_jax.live) == (
        dtype, count, pt.live)
    assert_same_search(jx, from_jax, queries, 10)
    assert_same_search(jx, from_jax, queries, 200)

    pt.save(str(tmp_path / "port.idx"))
    from_port = JaxFlatIndex.load(str(tmp_path / "port.idx"),
                                  device=jax.devices("cpu")[0])
    assert from_port.live == pt.live
    assert_same_search(from_port, pt, queries, 10)
    if count % 2 == 0:
        # The JAX package pads an odd int4 count's last byte with its
        # buffer's nibble; with an even count the files agree byte for byte.
        assert (tmp_path / "jax.idx").read_bytes() == (
            tmp_path / "port.idx").read_bytes()
    # a file loaded from the other package appends and searches on
    extra = normed(rng, 33, 128)
    from_jax.add(extra)
    jx.add(extra)
    assert_same_search(jx, from_jax, queries, 10)


def chunks_and_embeddings(rng, n, cls):
    chunks = [
        cls(id=f"chunk_{i:06d}", text=f"text {i}", metadata={
            "project_name": "alpha" if i % 3 else "beta",
            "session_id": f"s{i % 4}", "has_code": i % 5 == 0,
            "timestamp": f"2025-07-{1 + i % 28:02d}T00:00:00Z",
        })
        for i in range(n)
    ]
    return chunks, normed(rng, n, 128) * 2.0


@pytest.mark.parametrize("dtype", QUANT + ["pq"])
def test_hybrid_storage_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(4)
    jchunks, emb = chunks_and_embeddings(rng, 500, JaxChunk)
    pchunks = [Chunk(id=c.id, text=c.text, metadata=dict(c.metadata))
               for c in jchunks]
    stores = []
    for name, cls, cfg, chunks in (
        ("jax", JaxHybridStorage, JaxStorageConfig, jchunks),
        ("port", HybridStorage, StorageConfig, pchunks),
    ):
        store = cls(cfg(data_dir=str(tmp_path / name), embedding_dim=128,
                        storage_dtype=dtype, device="cpu"))
        store.initialize()
        store.add_chunks(chunks, embeddings=emb)
        stores.append(store)
    jax_store, port_store = stores
    assert port_store.index.dtype == jax_store.index.dtype == (
        "int4" if dtype == "pq" else dtype)
    assert port_store.get_stats()["storage_dtype"] == port_store.index.dtype
    queries = normed(rng, 3, 128)
    for filters in (None, {"project_name": "beta"}, {"has_code": True}):
        for k in (10, 200):
            want = jax_store.search_many(queries, JaxSearchConfig(top_k=k),
                                         filters)
            got = port_store.search_many(queries, SearchConfig(top_k=k),
                                         filters)
            assert [[(r.chunk_id, r.similarity) for r in rs] for rs in got] == [
                [(r.chunk_id, r.similarity) for r in rs] for rs in want]
    port_store.close()
    reopened = HybridStorage(StorageConfig(
        data_dir=str(tmp_path / "port"), embedding_dim=128,
        storage_dtype=dtype, device="cpu"))
    reopened.initialize()
    assert reopened.index.dtype == port_store.index.dtype
    got = reopened.search_many(queries, SearchConfig(top_k=10))
    want = jax_store.search_many(queries, JaxSearchConfig(top_k=10))
    assert [[r.chunk_id for r in rs] for rs in got] == [
        [r.chunk_id for r in rs] for rs in want]


@pytest.mark.parametrize("dtype,normalize,index_type,want", [
    ("int8", True, "flat", "int8"), ("int4", True, "flat", "int4"),
    ("int8", False, "flat", "bfloat16"), ("int4", False, "flat", "bfloat16"),
    ("pq", True, "flat", "int4"), ("pq", False, "flat", "bfloat16"),
    ("float32", False, "flat", "float32"), ("bfloat16", True, "hnsw", "bfloat16"),
])
def test_effective_dtype_matches_jax(tmp_path, dtype, normalize, index_type,
                                     want):
    kwargs = dict(embedding_dim=64, storage_dtype=dtype, device="cpu",
                  normalize_embeddings=normalize, index_type=index_type)
    jax_store = JaxHybridStorage(JaxStorageConfig(
        data_dir=str(tmp_path / "jax"), **kwargs))
    port_store = HybridStorage(StorageConfig(
        data_dir=str(tmp_path / "port"), **kwargs))
    assert port_store._effective_dtype() == jax_store._effective_dtype() == want
    port_store.initialize()
    assert port_store.index.dtype == want
    assert port_store.index.metric == ("ip" if normalize else "l2")
    port_store.close()
    # the load path resolves the same way and reads the saved index back
    again = HybridStorage(StorageConfig(data_dir=str(tmp_path / "port"),
                                        **kwargs))
    again.initialize()
    assert again.index.dtype == want


def test_ivf_and_pq_on_ivf_stay_refused(tmp_path):
    """Product quantization on IVF is ported: the pq and OPQ settings reach
    the IVF index as the JAX package's storage hands them on (pq_auto
    only without OPQ or a refine choice; OPQ only for pq)."""
    from tpu_search.storage.hybrid import HybridStorage as JaxHybridStorage
    from tpu_search.storage.hybrid import StorageConfig as JaxStorageConfig

    for i, kwargs in enumerate(({"storage_dtype": "pq"},
                                {"storage_dtype": "pq", "pq_opq": True},
                                {"storage_dtype": "pq",
                                 "refine_dtype": "bfloat16"},
                                {"storage_dtype": "int4", "pq_opq": True})):
        conf = dict(index_type="ivf", embedding_dim=32, ivf_nlist=4,
                    device="cpu", **kwargs)
        port = HybridStorage(StorageConfig(data_dir=str(tmp_path / f"p{i}"),
                                           **conf))
        port.initialize()
        ref = JaxHybridStorage(JaxStorageConfig(
            data_dir=str(tmp_path / f"j{i}"), **conf))
        ref.initialize()
        got, want = port.index, ref.index
        assert (got.dtype, got.pq_m, got.opq, got.pq_auto, got.refine_dtype,
                got.by_residual) == (want.dtype, want.pq_m, want.opq,
                                     want.pq_auto, want.refine_dtype,
                                     want.by_residual)
        port.close()
        ref.close()


@pytest.mark.parametrize("env,value", [
    ("CLAUDE_SEARCH_STORAGE_DTYPE", "fp8"),
    ("CLAUDE_SEARCH_STORAGE_DTYPE", "INT8"),
    ("CLAUDE_SEARCH_INDEX_TYPE", "annoy"),
])
def test_unknown_env_choice_raises(tmp_path, monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError, match=env):
        SearchEngine(str(tmp_path / "port"), model_name="tiny-mpnet",
                     device="cpu")
    with pytest.raises(ValueError, match=env):
        JaxSearchEngine(str(tmp_path / "jax"), model_name="tiny-mpnet",
                        use_warm_server=False)


@pytest.fixture(scope="module", params=QUANT)
def quant_engines(request, tmp_path_factory):
    dtype = request.param
    root = tmp_path_factory.mktemp(f"engines_{dtype}")
    files = write_transcripts(root)
    for name in ("jax", "port"):
        write_model(root / name / "models")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAUDE_SEARCH_STORAGE_DTYPE", dtype)
        jax_engine = JaxSearchEngine(str(root / "jax"),
                                     model_name="tiny-mpnet",
                                     use_warm_server=False)
        port_engine = SearchEngine(str(root / "port"),
                                   model_name="tiny-mpnet", device="cpu")
    jax_engine.storage.config.device = "cpu"
    jax_engine.embedder.config.device = "cpu"
    stats = [e.index_conversations(files) for e in (jax_engine, port_engine)]
    return dtype, root, jax_engine, port_engine, stats


def test_engine_matches_jax(quant_engines):
    dtype, _, jax_engine, port_engine, (jstats, pstats) = quant_engines
    assert port_engine.storage.index.dtype == jax_engine.storage.index.dtype
    assert port_engine.storage.index.dtype == dtype
    assert pstats["chunks_indexed"] == jstats["chunks_indexed"] > 6
    assert pstats["errors"] == jstats["errors"] == []
    tol = 5e-3 if dtype == "int8" else 2e-2
    for filters in (None, {"project_name": "myproj"}, {"has_code": True}):
        for query in QUERIES:
            ref = jax_engine.search_conversations(query, filters, top_k=10)
            got = port_engine.search_conversations(query, filters, top_k=5)
            assert got and len(got) == min(5, len(ref))
            ref_by_id = {r["chunk_id"]: r["similarity"] for r in ref}
            for a, b in zip(ref, got):
                assert abs(a["similarity"] - b["similarity"]) <= tol
                if a["chunk_id"] != b["chunk_id"]:  # a near-tie
                    assert abs(ref_by_id[b["chunk_id"]] - a["similarity"]) <= (
                        2 * tol)
            if filters and "has_code" in filters:
                assert all(r["has_code"] for r in got)
    # a chunk's own text finds it first (int8) or in the top 3 (int4: the
    # fixture's chunks share most words, so 4-bit codes can reorder them)
    storage = port_engine.storage
    for chunk_id in list(storage.chunk_id_to_faiss_id)[:6]:
        text = storage.get_chunk_by_id(chunk_id).text
        ids = [r["chunk_id"]
               for r in port_engine.search_conversations(text, top_k=3)]
        assert chunk_id == ids[0] if dtype == "int8" else chunk_id in ids


def test_engine_cli_search_json_on_the_saved_index(quant_engines):
    dtype, root, _, port_engine, _ = quant_engines
    port_engine.storage.save_index()
    env = dict(os.environ, CLAUDE_SEARCH_MODEL="tiny-mpnet",
               CLAUDE_SEARCH_STORAGE_DTYPE=dtype)
    out = subprocess.run(
        [sys.executable, "-m", "tpu_search_torch.interfaces.cli",
         "--data-dir", str(root / "port"), "--device", "cpu",
         "search", QUERIES[1], "--top-k", "5", "--json"],
        cwd=str(REPO), capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    want = port_engine.search_conversations(QUERIES[1], top_k=5)
    assert [i["uid"] for i in json.loads(out.stdout)["items"]] == [
        r["chunk_id"] for r in want]
    stats = port_engine.get_index_stats()
    assert stats["storage_dtype"] == dtype
