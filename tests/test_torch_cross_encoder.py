"""The port's cross-encoder reranker against the JAX package's on the CPU,
and rerank through the port's engine and CLI.

- ``classify`` logits against the jitted JAX ``classify`` with token types,
  f32, within 1e-4 (same math, sums in another order), in both attention
  layouts (hd 32 and hd 26);
- ``CrossEncoder.predict`` on the checked-in ``tiny-overlap`` reranker
  (a trained 2-layer BERT classifier, H 64: the ``[B, heads, S, hd]``
  attention) equals the JAX ``CrossEncoder`` within 1e-5 with the same
  ranks, and passes ``tests/test_rerank_quality.py``'s fixture checks;
- the engine's fetch size, rerank spec and degradation cases of
  ``tests/test_rerank.py`` (all but the socket ones), the hashing encoder
  and the lexical reranker end to end, the planted reordering of
  ``tests/test_rerank_quality.py``, and ``search --rerank --json``.
"""

import dataclasses
import functools
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rerank import TEXTS, write_corpus
from test_rerank_quality import MODEL, QUERY
from test_rerank_quality import TestEndToEndReordering as _Planted
from tpu_search.models import mpnet as jm
from tpu_search.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from tpu_search.models.cross_encoder import (
    CrossEncoderConfig as JaxCrossEncoderConfig,
)
from tpu_search_torch.api.engine import SearchEngine, rerank_fetch_k
from tpu_search_torch.models.convert import model_from_params
from tpu_search_torch.models.cross_encoder import (
    DEFAULT_RERANK_MODEL,
    CrossEncoder,
    CrossEncoderConfig,
)
from tpu_search_torch.models.mpnet import MPNetConfig, init_params

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"

RELEVANT = [
    "alpha bravo charlie delta echo foxtrot",
    "delta echo foxtrot alpha kilo lima",
    "bravo charlie delta mike november",
]
IRRELEVANT = [
    "apple banana cherry grape lemon mango",
    "kilo lima mike november oscar papa",
    "alphax bravox charliex deltax echox foxtrotx",
    "apple apple apple apple apple apple",
]


def classifier_config(hidden, heads):
    return MPNetConfig(vocab_size=120, hidden_size=hidden, num_layers=2,
                       num_heads=heads, intermediate_size=64,
                       max_position=40, layer_norm_eps=1e-12, pad_token_id=0,
                       arch="bert", pooling="cls", num_labels=1)


def pair_batch(rng, batch=4, seq=64, vocab=120):
    """``[CLS] a [SEP] b [SEP]``-shaped ids, token types and mask, padded
    past the 40-row position table (its last row is clamped)."""
    ids = np.zeros((batch, seq), np.int64)
    types = np.zeros((batch, seq), np.int64)
    mask = np.zeros((batch, seq), np.int32)
    for row in range(batch):
        len_a, len_b = int(rng.integers(2, 10)), int(rng.integers(2, 20))
        seq_ids = ([2] + list(rng.integers(5, vocab, len_a)) + [3]
                   + list(rng.integers(5, vocab, len_b)) + [3])
        n = len(seq_ids)
        ids[row, :n] = seq_ids
        types[row, len_a + 2:n] = 1
        mask[row, :n] = 1
    return ids, types, mask


@pytest.mark.parametrize("hidden,heads", [(128, 4), (78, 3)])
def test_classify_matches_jax(hidden, heads):
    cfg = classifier_config(hidden, heads)
    p = init_params(cfg, 11)
    rng = np.random.default_rng(12)
    for key in ("pooler_b", "cls_b"):
        p["head"][key] = (0.1 * rng.standard_normal(p["head"][key].shape)
                          ).astype(np.float32)
    ids, types, mask = pair_batch(rng)
    jcfg = jm.MPNetConfig(**dataclasses.asdict(cfg))
    fn = jax.jit(functools.partial(jm.classify, config=jcfg))
    ref = np.asarray(fn(p, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(types)))
    model = model_from_params(p, cfg)
    with torch.no_grad():
        got = model.classify(torch.from_numpy(ids), torch.from_numpy(mask),
                             torch.from_numpy(types)).numpy()
    assert got.shape == ref.shape == (4, 1)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # the token types matter: all-zero types move the logits
    with torch.no_grad():
        flat = model.classify(torch.from_numpy(ids), torch.from_numpy(mask),
                              torch.zeros_like(torch.from_numpy(types)))
    assert np.abs(flat.numpy() - got).max() > 1e-4


@pytest.fixture(scope="module")
def port_reranker():
    encoder = CrossEncoder(CrossEncoderConfig(
        model_name=MODEL, cache_dir=str(FIXTURES), device="cpu"))
    encoder.load_model()
    return encoder


def test_predict_equals_jax_on_the_fixture(port_reranker):
    ref = JaxCrossEncoder(JaxCrossEncoderConfig(
        model_name=MODEL, cache_dir=str(FIXTURES), device="cpu"))
    pairs = [(QUERY, p) for p in RELEVANT + IRRELEVANT]
    pairs += [("kilo lima", "kilo lima mike"), ("", "alpha"),
              (QUERY * 20, "alpha " * 40)]  # truncated to 34 positions
    got, want = port_reranker.predict(pairs), ref.predict(pairs)
    assert port_reranker._model.layers[0].layout == "bhsd"
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert list(np.argsort(-got, kind="stable")) == list(
        np.argsort(-want, kind="stable"))
    # batching does not change a score
    small = CrossEncoder(CrossEncoderConfig(
        model_name=MODEL, cache_dir=str(FIXTURES), device="cpu",
        batch_size=3))
    np.testing.assert_allclose(small.predict(pairs), got, atol=1e-6, rtol=0)


class TestFixtureQuality:
    """``tests/test_rerank_quality.py::TestFixtureQuality``, on the port."""

    def test_scores_separate_relevant_from_irrelevant(self, port_reranker):
        scores = port_reranker.predict(
            [(QUERY, p) for p in RELEVANT + IRRELEVANT])
        rel, irr = scores[: len(RELEVANT)], scores[len(RELEVANT):]
        assert rel.min() > irr.max(), (rel, irr)
        assert rel.mean() > 0.9
        assert irr.mean() < 0.1

    def test_rank_orders_by_overlap(self, port_reranker):
        docs = [
            "apple banana cherry grape lemon mango",
            "alpha bravo charlie delta echo foxtrot",
            "alpha bravo charlie kilo lima mike",
        ]
        ranked = port_reranker.rank(QUERY, docs)
        assert ranked[0]["corpus_id"] in (1, 2)
        assert ranked[1]["corpus_id"] in (1, 2)
        assert ranked[-1]["corpus_id"] == 0
        assert ranked[0]["score"] > ranked[-1]["score"]


def test_embedding_model_and_missing_model_refused(tmp_path):
    cfg = dataclasses.replace(classifier_config(128, 4), num_labels=0)
    from tpu_search_torch.models.convert import save_checkpoint

    save_checkpoint(str(tmp_path / "embedder" / "model.tpu.npz"),
                    init_params(cfg, 0), cfg)
    (tmp_path / "embedder" / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    with pytest.raises(ValueError, match="no classification head"):
        CrossEncoder(CrossEncoderConfig(
            model_name="embedder", cache_dir=str(tmp_path),
            device="cpu")).load_model()
    with pytest.raises(FileNotFoundError):
        CrossEncoder(CrossEncoderConfig(
            model_name="absent", cache_dir=str(tmp_path),
            device="cpu")).load_model()


def test_hash_reranker_orders_by_overlap():
    encoder = CrossEncoder(CrossEncoderConfig(model_name="hash-256"))
    scores = encoder.predict([("install jax tpu", "install jax on a tpu"),
                              ("install jax tpu", "chocolate cake")])
    assert scores[0] > scores[1]
    assert encoder.predict([]).shape == (0,)


# -- the engine (tests/test_rerank.py, without the socket cases) -------------


@pytest.fixture
def engine(tmp_path):
    engine = SearchEngine(str(tmp_path / "data"), model_name="hash-768",
                          device="cpu")
    engine.index_conversations(write_corpus(tmp_path / "proj", TEXTS))
    return engine


class _StubReranker:
    """Deterministic reranker: score = text length."""

    def predict(self, pairs):
        return np.array([float(len(b)) for _, b in pairs], dtype=np.float32)


@pytest.mark.parametrize("top_k,spec,want", [
    (10, {"factor": 5}, 50), (40, {"factor": 5}, 100),
    (150, {"factor": 2}, 150), (10, {"factor": "x"}, 50), (10, {}, 50),
])
def test_rerank_fetch_k(top_k, spec, want):
    assert rerank_fetch_k(top_k, spec) == want


class TestSpecResolution:
    def test_default_off(self, engine, monkeypatch):
        monkeypatch.delenv("CLAUDE_SEARCH_RERANK", raising=False)
        assert engine._rerank_spec(None, None, None) is None

    def test_env_enables(self, engine, monkeypatch):
        monkeypatch.setenv("CLAUDE_SEARCH_RERANK", "1")
        monkeypatch.delenv("CLAUDE_SEARCH_RERANK_MODEL", raising=False)
        monkeypatch.delenv("CLAUDE_SEARCH_RERANK_FACTOR", raising=False)
        assert engine._rerank_spec(None, None, None) == {
            "factor": 5, "model": DEFAULT_RERANK_MODEL}

    def test_env_model_and_factor(self, engine, monkeypatch):
        monkeypatch.setenv("CLAUDE_SEARCH_RERANK_MODEL", "hash-32")
        monkeypatch.setenv("CLAUDE_SEARCH_RERANK_FACTOR", "3")
        assert engine._rerank_spec(True, None, None) == {
            "factor": 3, "model": "hash-32"}

    def test_explicit_false_overrides_env(self, engine, monkeypatch):
        monkeypatch.setenv("CLAUDE_SEARCH_RERANK", "1")
        assert engine._rerank_spec(False, None, None) is None

    def test_model_and_factor_carried(self, engine):
        assert engine._rerank_spec(True, "my-model", 3) == {
            "factor": 3, "model": "my-model"}


class TestEngineRerank:
    def test_rerank_reorders_and_annotates(self, engine, monkeypatch):
        monkeypatch.setattr(engine, "_get_reranker",
                            lambda model=None: _StubReranker())
        results = engine.search_conversations("install jax tpu", top_k=3,
                                              rerank=True)
        assert len(results) == 3
        scores = [r["rerank_score"] for r in results]
        assert scores == sorted(scores, reverse=True)
        assert len(results[0]["text"]) == max(len(r["text"]) for r in results)
        assert all("similarity" in r for r in results)

    def test_rerank_respects_top_k(self, engine, monkeypatch):
        monkeypatch.setattr(engine, "_get_reranker",
                            lambda model=None: _StubReranker())
        results = engine.search_conversations("install jax tpu", top_k=2,
                                              rerank=True, rerank_factor=2)
        assert len(results) == 2

    def test_hash_reranker_end_to_end(self, engine, monkeypatch):
        monkeypatch.setenv("CLAUDE_SEARCH_RERANK_MODEL", "hash-256")
        results = engine.search_conversations("install jax on tpu", top_k=3,
                                              rerank=True)
        assert all("rerank_score" in r for r in results)
        assert "cake" not in results[0]["text"]

    def test_missing_model_degrades_gracefully(self, engine, caplog):
        with caplog.at_level(logging.WARNING):
            results = engine.search_conversations(
                "install jax on tpu", top_k=3, rerank=True,
                rerank_model="definitely-not-downloaded")
        assert len(results) == 3
        assert all("rerank_score" not in r for r in results)
        assert "definitely-not-downloaded" in engine._reranker_failed
        assert "definitely-not-downloaded" in caplog.text
        results = engine.search_conversations(
            "install jax on tpu", top_k=3, rerank=True,
            rerank_model="definitely-not-downloaded")
        assert len(results) == 3

    def test_device_errors_propagate(self, engine, monkeypatch):
        """Only a missing checkpoint or a headless one degrades; an error
        of the device or a kernel reaches the caller."""
        def broken(self):
            raise RuntimeError("CUDA error 700")

        monkeypatch.setattr(CrossEncoder, "load_model", broken)
        with pytest.raises(RuntimeError, match="CUDA error"):
            engine.search_conversations("install jax", top_k=3, rerank=True,
                                        rerank_model="any")

    def test_bad_device_propagates(self, engine):
        """An unsupported device is an error of the caller, not a missing
        reranker: it raises and is not remembered as a failed model."""
        engine.embedder.config.device = "meta"
        with pytest.raises(ValueError, match="unsupported device"):
            engine.search_conversations("install jax", top_k=3, rerank=True,
                                        rerank_model=MODEL)
        assert MODEL not in engine._reranker_failed

    def test_no_rerank_without_flag(self, engine, monkeypatch):
        monkeypatch.delenv("CLAUDE_SEARCH_RERANK", raising=False)
        results = engine.search_conversations("install jax on tpu", top_k=3)
        assert all("rerank_score" not in r for r in results)


def test_hash_encoder_end_to_end(engine, tmp_path):
    """``hash-768`` indexes on the host and searches through the index:
    each text finds itself first, with the JAX engine's ids and
    similarities (bf16 storage in both: within 5e-3)."""
    from tpu_search.api.engine import SearchEngine as JaxSearchEngine

    ref = JaxSearchEngine(str(tmp_path / "jax"), model_name="hash-768",
                          use_warm_server=False)
    ref.storage.config.device = "cpu"
    ref.index_conversations(write_corpus(tmp_path / "proj", TEXTS))
    assert engine.embedder.embedding_dimension == 768
    assert engine.get_index_stats()["total_chunks"] == len(TEXTS)
    for text in TEXTS:
        got = engine.search_conversations(text, top_k=3)
        want = ref.search_conversations(text, top_k=3)
        assert text.strip()[:40] in got[0]["text"]
        assert got[0]["similarity"] > 0.95  # the chunk adds a turn header
        assert [r["chunk_id"] for r in got] == [r["chunk_id"] for r in want]
        np.testing.assert_allclose([r["similarity"] for r in got],
                                   [r["similarity"] for r in want], atol=5e-3)


class TestPlantedReordering(_Planted):
    """``tests/test_rerank_quality.py::TestEndToEndReordering`` on the
    port's engine: the hashing bi-encoder ranks character-similar decoys
    above the relevant chunk; the trained cross-encoder repairs it."""

    @pytest.fixture
    def engine(self, tmp_path):
        engine = SearchEngine(str(tmp_path / "data"), model_name="hash-768",
                              device="cpu")
        shutil.copytree(FIXTURES / MODEL, engine.data_dir / "models" / MODEL)
        engine.index_conversations(write_corpus(tmp_path / "proj",
                                                self.TEXTS))
        return engine


def test_cli_search_rerank_json(tmp_path):
    engine = SearchEngine(str(tmp_path / "data"), model_name="hash-768",
                          device="cpu")
    shutil.copytree(FIXTURES / MODEL, engine.data_dir / "models" / MODEL)
    engine.index_conversations(write_corpus(tmp_path / "proj",
                                            _Planted.TEXTS))
    engine.storage.save_index()
    want = engine.search_conversations(QUERY, top_k=3, rerank=True,
                                       rerank_model=MODEL)
    env = dict(os.environ, CLAUDE_SEARCH_MODEL="hash-768")
    base = [sys.executable, "-m", "tpu_search_torch.interfaces.cli",
            "--data-dir", str(tmp_path / "data"), "--device", "cpu",
            "search", QUERY, "--top-k", "3", "--rerank", "--rerank-model",
            MODEL, "--rerank-factor", "2"]
    out = subprocess.run(base + ["--json"], cwd=str(REPO), capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    items = json.loads(out.stdout)["items"]
    assert [i["uid"] for i in items] == [r["chunk_id"] for r in want]
    assert _Planted.RELEVANT in items[0]["text"]
    out = subprocess.run(base, cwd=str(REPO), capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "1. [Rerank: " in out.stdout and "| Similarity: " in out.stdout
