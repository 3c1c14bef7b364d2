"""``CLAUDE_SEARCH_INDEX_TYPE=ivf`` end to end on the CPU: both packages'
``SearchEngine`` index the verify-skill fixture with the same tiny
checkpoint into an IVF index (bf16, int8, and int4 with its automatic int8
refine tier), and must agree.

The two packages train their coarse quantizers with different random
numbers, so the engines run with ``CLAUDE_SEARCH_NPROBE`` above nlist
(every cluster probed) and the results are those of an exact scan over
the storage dtype.  Tolerances: similarities within 5e-3 (bf16: compute
rounding, as ``test_torch_engine.py``), 2e-2 (int8: residuals against
different centroids quantize differently) and 5e-3 (int4: the refine
tier's int8 rows are the same in both); ids equal outside near-ties.
Also: the env knobs validated as the JAX engine validates them, ``pq``
on IVF and OPQ refused, ``optimize`` through the engine and the CLI.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_engine import QUERIES, write_model
from test_torch_host_copies import write_transcripts
from tpu_search.api.engine import SearchEngine as JaxSearchEngine
from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.index.flat import FlatIndex
from tpu_search_torch.index.ivf import IVFIndex
from tpu_search_torch.storage.hybrid import HybridStorage, StorageConfig

REPO = Path(__file__).resolve().parent.parent
TOL = {"bfloat16": 5e-3, "int8": 2e-2, "int4": 5e-3}
ENV = {"CLAUDE_SEARCH_INDEX_TYPE": "ivf", "CLAUDE_SEARCH_NPROBE": "64"}


@pytest.fixture(scope="module", params=["bfloat16", "int8", "int4"])
def ivf_engines(request, tmp_path_factory):
    dtype = request.param
    root = tmp_path_factory.mktemp(f"ivf_{dtype}")
    files = write_transcripts(root)
    for name in ("jax", "port"):
        write_model(root / name / "models")
    env = dict(ENV, CLAUDE_SEARCH_STORAGE_DTYPE=dtype)
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        jax_engine = JaxSearchEngine(str(root / "jax"), model_name="tiny-mpnet",
                                     use_warm_server=False)
        port_engine = SearchEngine(str(root / "port"), model_name="tiny-mpnet",
                                   device="cpu")
    jax_engine.storage.config.device = "cpu"
    jax_engine.embedder.config.device = "cpu"
    stats = [e.index_conversations(files) for e in (jax_engine, port_engine)]
    return dtype, root, env, jax_engine, port_engine, stats


def test_ivf_engine_matches_jax(ivf_engines):
    dtype, _, _, jax_engine, port_engine, (jstats, pstats) = ivf_engines
    index = port_engine.storage.index
    assert isinstance(index, IVFIndex) and index.dtype == dtype
    assert type(jax_engine.storage.index).__name__ == "IVFIndex"
    assert index.nlist == jax_engine.storage.index.nlist
    assert index.refine_dtype == jax_engine.storage.index.refine_dtype == (
        "int8" if dtype == "int4" else "none")
    assert pstats["chunks_indexed"] == jstats["chunks_indexed"] > 6
    assert pstats["errors"] == jstats["errors"] == []
    tol = TOL[dtype]
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


def test_ivf_cli_search_and_optimize(ivf_engines):
    dtype, root, env, _, port_engine, _ = ivf_engines
    port_engine.storage.save_index()
    run_env = dict(os.environ, CLAUDE_SEARCH_MODEL="tiny-mpnet", **env)
    cli = [sys.executable, "-m", "tpu_search_torch.interfaces.cli",
           "--data-dir", str(root / "port"), "--device", "cpu"]
    out = subprocess.run(cli + ["search", QUERIES[1], "--top-k", "5", "--json"],
                         cwd=str(REPO), capture_output=True, text=True,
                         env=run_env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = port_engine.search_conversations(QUERIES[1], top_k=5)
    assert [i["uid"] for i in json.loads(out.stdout)["items"]] == [
        r["chunk_id"] for r in want]
    out = subprocess.run(cli + ["optimize"], cwd=str(REPO),
                         capture_output=True, text=True, env=run_env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Optimization complete" in out.stdout
    stats = port_engine.get_index_stats()
    assert stats["storage_dtype"] == dtype and stats["index_type"] == "ivf"


def test_engine_optimize_compacts(ivf_engines):
    dtype, root, env, _, port_engine, _ = ivf_engines
    storage = port_engine.storage
    chunk_id = next(iter(storage.chunk_id_to_faiss_id))
    path = storage.get_chunk_by_id(chunk_id).metadata["file_path"]
    removed = storage.remove_chunks_for_file(path)
    assert removed and storage.index.live < storage.index.ntotal
    port_engine.optimize()
    assert storage.index.live == storage.index.ntotal
    assert sorted(storage.faiss_id_to_chunk_id) == list(
        range(storage.index.ntotal))
    results = port_engine.search_conversations(QUERIES[0], top_k=3)
    assert results and all(r["text"] for r in results)


@pytest.mark.parametrize("env,value,error", [
    ("CLAUDE_SEARCH_NPROBE", "eight", ValueError),
    ("CLAUDE_SEARCH_AUTOTUNE_RECALL", "high", ValueError),
    ("CLAUDE_SEARCH_REFINE", "int4", ValueError),
    ("CLAUDE_SEARCH_REFINE_FACTOR", "4.5", ValueError),
    ("CLAUDE_SEARCH_PQ_OPQ", "yes", ValueError),
])
def test_ivf_env_knobs_validated_as_jax(tmp_path, monkeypatch, env, value,
                                        error):
    monkeypatch.setenv(env, value)
    with pytest.raises(error, match=env):
        SearchEngine(str(tmp_path / "port"), model_name="tiny-mpnet",
                     device="cpu")
    with pytest.raises(error, match=env):
        JaxSearchEngine(str(tmp_path / "jax"), model_name="tiny-mpnet",
                        use_warm_server=False)


def test_ivf_env_knobs_reach_storage(tmp_path, monkeypatch):
    for key, value in {"CLAUDE_SEARCH_INDEX_TYPE": "ivf",
                       "CLAUDE_SEARCH_NPROBE": "16",
                       "CLAUDE_SEARCH_AUTOTUNE_RECALL": "0.9",
                       "CLAUDE_SEARCH_REFINE": "bfloat16",
                       "CLAUDE_SEARCH_REFINE_FACTOR": "6"}.items():
        monkeypatch.setenv(key, value)
    engine = SearchEngine(str(tmp_path), model_name="tiny-mpnet", device="cpu")
    cfg = engine.storage.config
    assert (cfg.index_type, cfg.ivf_autotune_recall, cfg.refine_dtype,
            cfg.refine_factor, engine._default_nprobe) == (
        "ivf", 0.9, "bfloat16", 6, 16)


def test_pq_on_ivf_and_opq_refused(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError):
        HybridStorage(StorageConfig(data_dir=str(tmp_path), device="cpu",
                                    index_type="ivf", storage_dtype="pq"))
    with pytest.raises(NotImplementedError):
        HybridStorage(StorageConfig(data_dir=str(tmp_path), device="cpu",
                                    index_type="ivf", pq_opq=True))
    monkeypatch.setenv("CLAUDE_SEARCH_PQ_OPQ", "1")
    with pytest.raises(NotImplementedError):
        SearchEngine(str(tmp_path), model_name="tiny-mpnet", device="cpu")


@pytest.mark.parametrize("index_type,refine,normalize,want", [
    ("flat", "int8", True, "none"), ("ivf", "int8", True, "int8"),
    ("ivf", "bfloat16", False, "none"), ("ivf", "none", True, "none"),
])
def test_effective_refine_matches_jax(tmp_path, index_type, refine, normalize,
                                      want):
    from tpu_search.storage.hybrid import HybridStorage as JaxHybridStorage
    from tpu_search.storage.hybrid import StorageConfig as JaxStorageConfig

    kwargs = dict(index_type=index_type, refine_dtype=refine,
                  normalize_embeddings=normalize, device="cpu")
    jax_store = JaxHybridStorage(JaxStorageConfig(
        data_dir=str(tmp_path / "jax"), **kwargs))
    port_store = HybridStorage(StorageConfig(
        data_dir=str(tmp_path / "port"), **kwargs))
    assert port_store._effective_refine() == jax_store._effective_refine() == (
        want)


def test_flat_index_device_default(monkeypatch):
    """``FlatIndex(dim)`` resolves its device like every entry point: cuda
    by default (raising without a card), ``CLAUDE_SEARCH_DEVICE=cpu`` on
    request."""
    monkeypatch.delenv("CLAUDE_SEARCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        assert FlatIndex(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FlatIndex(8)
        with pytest.raises(RuntimeError, match="CUDA"):
            IVFIndex(8)
    monkeypatch.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
    assert FlatIndex(8).device == torch.device("cpu")
    index = FlatIndex(8)
    index.add(np.eye(8, dtype=np.float32))
    assert index.search(np.eye(8, dtype=np.float32)[:1], 1)[1][0, 0] == 0
