"""The port's ``EmbeddingStats`` and ``EmbeddingGenerator`` utilities
(similarity, stats, npz persistence, validation, model info, device
facts, the benchmark) against the JAX package's on the same inputs, the
cases of ``tests/test_encoder.py`` among them; and ``models/setup.py
--from-dir`` on a small random HF-format directory writing the
``model.tpu.npz`` the JAX package's setup writes, array by array, then
verifying on the CPU.
"""

import dataclasses
import sys

import numpy as np
import pytest

from tpu_search.ingest.chunker import Chunk as JaxChunk
from tpu_search.models.encoder import EmbeddingConfig as JaxEmbeddingConfig
from tpu_search.models.encoder import EmbeddingGenerator as JaxGenerator
from tpu_search_torch.ingest.chunker import Chunk
from tpu_search_torch.models import EmbeddingStats
from tpu_search_torch.models.encoder import EmbeddingConfig, EmbeddingGenerator
from tpu_search_torch.models.mpnet import MPNetConfig
from tpu_search_torch.utils.synthetic import write_hf_model

TEXTS = ["one two", "three", "four five six seven", "eight nine"]


def _gen(name="hash-32"):
    port = EmbeddingGenerator(EmbeddingConfig(model_name=name, device="cpu"))
    ref = JaxGenerator(JaxEmbeddingConfig(model_name=name, device="cpu"))
    port.load_model()
    ref.load_model()
    return port, ref


def _chunks(kind, texts):
    return [kind(id=f"c{i}", text=t, metadata={"i": i})
            for i, t in enumerate(texts)]


def test_similarity_utilities_equal():
    port, ref = _gen()
    rng = np.random.default_rng(0)
    pool = list(rng.standard_normal((6, 8)).astype(np.float32))
    query = rng.standard_normal(8).astype(np.float32)
    assert port.compute_similarity(pool[0], pool[1]) == (
        ref.compute_similarity(pool[0], pool[1]))
    np.testing.assert_array_equal(port.compute_similarity_matrix(pool),
                                  ref.compute_similarity_matrix(pool))
    assert port.find_similar_chunks(query, pool, top_k=3) == (
        ref.find_similar_chunks(query, pool, top_k=3))
    a, b = np.array([1.0, 0.0]), np.array([0.0, 1.0])
    assert port.compute_similarity(a, a) == pytest.approx(1.0)
    assert port.compute_similarity(a, b) == pytest.approx(0.0)
    pool = [np.array([0.9, 0.1]), np.array([0.0, 1.0]), np.array([1.0, 0.05])]
    assert [i for i, _ in port.find_similar_chunks(a, pool, top_k=2)] == [2, 0]


def test_embedding_stats_equal():
    port, ref = _gen()
    got = port.get_embedding_stats(_chunks(Chunk, TEXTS))
    want = ref.get_embedding_stats(_chunks(JaxChunk, TEXTS))
    assert isinstance(got, EmbeddingStats)
    assert (got.total_chunks, got.total_tokens, got.average_chunk_length) == (
        want.total_chunks, want.total_tokens, want.average_chunk_length)
    assert got.total_chunks == 4 and got.total_tokens == 9
    assert port.get_embedding_stats([]) == EmbeddingStats()
    assert [f.name for f in dataclasses.fields(EmbeddingStats)] == [
        f.name for f in dataclasses.fields(type(want))]


def test_model_info_and_device_facts():
    port, ref = _gen()
    got, want = port.get_model_info(), ref.get_model_info()
    for key in ("model_name", "embedding_dimension", "max_seq_length",
                "compute_dtype"):
        assert got[key] == want[key]
    assert got["embedding_dimension"] == 32
    assert port.is_using_gpu is False and port._memory_info() == {}
    assert EmbeddingGenerator().get_model_info() == {}
    assert not any("tpu" in str(v).lower() for v in got.values())


def test_validate_embeddings_equal():
    port, ref = _gen()
    p_chunks, j_chunks = _chunks(Chunk, TEXTS[:2]), _chunks(JaxChunk, TEXTS[:2])
    port.generate_embeddings(p_chunks)
    ref.generate_embeddings(j_chunks)
    p_chunks.append(Chunk(id="missing", text="x", metadata={}))
    j_chunks.append(JaxChunk(id="missing", text="x", metadata={}))
    p_chunks.append(Chunk(id="short", text="y", metadata={},
                          embedding=[1.0, 0.0]))
    j_chunks.append(JaxChunk(id="short", text="y", metadata={},
                             embedding=[1.0, 0.0]))
    got, want = port.validate_embeddings(p_chunks), ref.validate_embeddings(
        j_chunks)
    assert got == want
    assert got["chunks_with_embeddings"] == 3 and len(got["issues"]) == 2
    report = port.validate_embeddings(p_chunks[:2])
    assert report["embedding_dimension"] == 32
    assert report["embedding_stats"]["norm_mean"] == pytest.approx(1.0,
                                                                   abs=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_embeddings_npz_loads_in_both(tmp_path, writer):
    port, ref = _gen()
    p_chunks, j_chunks = _chunks(Chunk, TEXTS), _chunks(JaxChunk, TEXTS)
    port.generate_embeddings(p_chunks)
    ref.generate_embeddings(j_chunks)
    path = str(tmp_path / "emb.npz")
    (port.save_embeddings(p_chunks, path) if writer == "port"
     else ref.save_embeddings(j_chunks, path))
    for loaded in (port.load_embeddings(path), ref.load_embeddings(path)):
        assert [(c.id, c.text, c.metadata, list(c.embedding))
                for c in loaded] == [
            (c.id, c.text, c.metadata, list(c.embedding)) for c in p_chunks]


def test_benchmark_model_shape():
    port, _ = _gen()
    report = port.benchmark_model(TEXTS * 2, warmup_runs=1)
    assert report["device"] == "None" and report["embedding_dimension"] == 32
    assert sorted(report["performance"]) == ["batch_size_1", "batch_size_4",
                                             "batch_size_8"]
    assert all(v["throughput"] > 0 for v in report["performance"].values())


SMALL = MPNetConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, max_position=80)


def test_setup_from_dir_writes_the_jax_checkpoint(tmp_path, monkeypatch,
                                                  capsys):
    """``--from-dir`` copies the HF directory into the model cache,
    converts it and verifies it on the CPU; the ``model.tpu.npz`` equals,
    array by array, the JAX package's setup output from the same source."""
    from tpu_search.models import setup as jax_setup
    from tpu_search_torch.models import setup as port_setup

    source = tmp_path / "hf-download"
    write_hf_model(source, SMALL, seed=3)
    outputs = {}
    for name in ("port", "jax"):
        monkeypatch.setenv("CLAUDE_SEARCH_DATA_DIR", str(tmp_path / name))
        argv = ["--from-dir", str(source), "--model", "tiny-hf"]
        if name == "port":
            port_setup.main([*argv, "--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["setup-models", *argv])
            jax_setup.main()
        out = capsys.readouterr().out
        assert "Model ready" in out and "norms ok=True" in out, out
        outputs[name] = tmp_path / name / "models" / "tiny-hf" / (
            "model.tpu.npz")
    with np.load(outputs["port"]) as got, np.load(outputs["jax"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in got.files:
            np.testing.assert_array_equal(got[key], want[key])


def test_setup_system_info_names_torch():
    from tpu_search_torch.models import setup as port_setup

    info = port_setup.get_system_info()
    assert info["torch"] and "cuda" in info
    assert info["device_count"] == len(info["devices"])
