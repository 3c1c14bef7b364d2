"""The port's fused query path (``SearchEngine._fused_search_many``,
``api/fused.py``) on the CPU, with the tiny checkpoint of
``test_torch_engine.py``, on flat bf16, int8 and int4 and on IVF int4 with
its refine tier (``tests/test_torch_fused_sharded.py`` and
``tests/test_torch_fused_sharded_ivf.py`` run the same cases on sharded
flat and IVF stores):

- against the port's classic path (embed, then ``HybridStorage.
  search_many``) on the same engine: equal ids, similarities within 1e-6;
- against the JAX engine's ``_fused_search_many`` on the same corpus: ids
  equal outside near-ties, similarities within ``TOL`` (5e-3 as
  ``tests/test_torch_engine.py``; 2e-2 for int8 / int4 flat storage, whose
  rows quantize embeddings that differ by the two frameworks' bf16
  rounding);
- at windows of 1, 8, 9 and 32 queries, unfiltered and filtered, and
  after an ``add`` and a ``remove_chunks_for_files``;
- ``hydrate_wire``'s fragments against ``hydrate_results`` +
  ``format_search_result``, and its cache cleared on a ``_data_version``
  bump;
- the structural ``None`` / ``[[] ...]`` cases, and an error inside the
  fused program propagating instead of returning classic results.

The IVF engines probe every cluster (``CLAUDE_SEARCH_NPROBE`` above
nlist), as ``test_torch_engine_ivf.py`` does: the two packages train
their coarse quantizers with different random numbers.
"""

import json

import pytest

from test_torch_engine import write_model
from test_torch_host_copies import write_transcripts
from tpu_search.api.engine import SearchEngine as JaxSearchEngine
from tpu_search.storage.hybrid import SearchConfig as JaxSearchConfig
from tpu_search_torch.api import engine as engine_mod
from tpu_search_torch.api.engine import SearchEngine, format_search_result
from tpu_search_torch.storage.hybrid import SearchConfig

SIM_EQ = 1e-6
TOL = {("flat", "bfloat16"): 5e-3, ("flat", "int8"): 2e-2,
       ("flat", "int4"): 2e-2, ("ivf", "int4"): 5e-3,
       ("sharded", "bfloat16"): 5e-3, ("sharded", "int8"): 2e-2,
       ("sharded_ivf", "bfloat16"): 5e-3, ("sharded_ivf", "int8"): 2e-2}
QUERIES = [f"tok{i} tok{(i + 3) % 59} tok{(i + 7) % 59}" for i in range(32)]
WINDOWS = (1, 8, 9, 32)
FILTERS = (None, {"has_code": True})


def _env(kind: str, dtype: str) -> dict:
    env = {"CLAUDE_SEARCH_STORAGE_DTYPE": dtype}
    if kind == "ivf":
        env.update(CLAUDE_SEARCH_INDEX_TYPE="ivf", CLAUDE_SEARCH_NPROBE="64")
    if kind.startswith("sharded"):
        env.update(CLAUDE_SEARCH_SHARD_DEVICES="8")
    if kind == "sharded_ivf":
        env.update(CLAUDE_SEARCH_INDEX_TYPE="ivf", CLAUDE_SEARCH_NPROBE="64")
    return env


def make_engines(config, tmp_path_factory):
    """A JAX and a port engine of ``config`` (kind, dtype) over the same
    transcripts."""
    kind, dtype = config
    root = tmp_path_factory.mktemp(f"fused_{kind}_{dtype}")
    files = write_transcripts(root)
    for name in ("jax", "port"):
        write_model(root / name / "models")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in _env(kind, dtype).items():
            mp.setenv(key, value)
        jax_engine = JaxSearchEngine(str(root / "jax"), model_name="tiny-mpnet",
                                     use_warm_server=False)
        port_engine = SearchEngine(str(root / "port"), model_name="tiny-mpnet",
                                   use_warm_server=False, device="cpu")
    jax_engine.storage.config.device = "cpu"
    jax_engine.embedder.config.device = "cpu"
    for engine in (jax_engine, port_engine):
        engine.index_conversations(files)
    assert port_engine.storage.index.dtype == dtype
    sharded = {"sharded": "ShardedFlatIndex",
               "sharded_ivf": "ShardedIVFIndex"}.get(kind)
    for engine in (jax_engine, port_engine):
        index = engine.storage.index
        assert (type(index).__name__ == sharded) == bool(sharded)
        assert getattr(index, "n_shards", 8) == 8
    return (kind, dtype), root, jax_engine, port_engine


@pytest.fixture(scope="module", params=sorted(
    k for k in TOL if not k[0].startswith("sharded")))
def engines(request, tmp_path_factory):
    return make_engines(request.param, tmp_path_factory)


def classic(engine, queries, filters, cfg):
    """The port's classic path: one embed batch, then one scan."""
    return engine.storage.search_many(
        engine.embedder._encode_texts(queries), cfg, filters)


def assert_equal_results(fused, ref):
    """Same ids, similarities within ``SIM_EQ``."""
    assert len(fused) == len(ref)
    for got, want in zip(fused, ref):
        assert [r.chunk_id for r in got] == [r.chunk_id for r in want]
        for a, b in zip(got, want):
            assert abs(a.similarity - b.similarity) <= SIM_EQ


def assert_close_results(fused, ref, tol):
    """Ids equal outside near-ties, similarities within ``tol``; ``ref``
    holds each query's top 2k, so a near-tie across the cut is found."""
    assert len(fused) == len(ref)
    for got, want in zip(fused, ref):
        assert len(got) == min(len(want), 5)
        want_by_id = {r.chunk_id: r.similarity for r in want}
        for a, b in zip(got, want):
            assert abs(a.similarity - b.similarity) <= tol
            if a.chunk_id != b.chunk_id:  # a near-tie
                other = want_by_id.get(a.chunk_id)
                assert other is not None
                assert abs(other - b.similarity) <= 2 * tol


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("window", WINDOWS)
def test_fused_matches_classic_and_jax(engines, window, filters):
    config, _, jax_engine, port_engine = engines
    queries = QUERIES[:window]
    fused = port_engine._fused_search_many(queries, filters,
                                           SearchConfig(top_k=5))
    assert fused is not None and len(fused) == window
    assert all(fused)
    assert_equal_results(fused, classic(port_engine, queries, filters,
                                        SearchConfig(top_k=5)))
    ref = jax_engine._fused_search_many(queries, filters,
                                        JaxSearchConfig(top_k=10))
    assert ref is not None
    assert_close_results(fused, ref, TOL[config])
    if filters:
        assert all(r.metadata["has_code"] for rs in fused for r in rs)


def test_fused_sees_an_add_and_a_remove(engines, tmp_path):
    _, _, _, port_engine = engines
    path = tmp_path / "claude-projects" / "-root-fresh" / "new.jsonl"
    path.parent.mkdir(parents=True)
    text = " ".join(f"tok{(5 * j) % 59}" for j in range(40))
    path.write_text("".join(json.dumps({
        "uuid": f"n{i}", "sessionId": "fresh",
        "timestamp": f"2025-07-03T09:0{i}:00Z",
        "message": {"role": role,
                    "content": [{"type": "text", "text": text}]},
    }) + "\n" for i, role in enumerate(("user", "assistant"))))
    cfg = SearchConfig(top_k=3)
    storage = port_engine.storage
    before = set(storage.chunk_id_to_faiss_id)
    stats = port_engine.index_conversations([path])
    assert stats["chunks_indexed"] == 1
    (new_id,) = set(storage.chunk_id_to_faiss_id) - before
    query = storage.get_chunk_by_id(new_id).text
    try:
        fused = port_engine._fused_search_many([query], None, cfg)
        assert_equal_results(fused, classic(port_engine, [query], None, cfg))
        assert fused[0][0].chunk_id == new_id
        assert abs(fused[0][0].similarity - 1.0) <= 5e-2
    finally:
        removed = storage.remove_chunks_for_files([str(path)])
    assert removed == 1 and set(storage.chunk_id_to_faiss_id) == before
    fused = port_engine._fused_search_many([query], None, cfg)
    assert new_id not in [r.chunk_id for r in fused[0]]
    assert_equal_results(fused, classic(port_engine, [query], None, cfg))


def test_hydrate_wire_matches_hydrate_results(engines):
    _, _, _, port_engine = engines
    storage = port_engine.storage
    cfg = SearchConfig(top_k=4)
    pending = port_engine._fused_dispatch_many(QUERIES[:3], None, cfg)
    scores, ids = port_engine._fused_fetch(pending)
    frags = storage.hydrate_wire(scores, ids, cfg)
    results = storage.hydrate_results(scores, ids, cfg)
    assert len(frags) == len(results) == 3
    for got, want in zip(frags, results):
        assert len(got) == len(want) > 0
        for frag, result in zip(got, want):
            assert json.loads(frag) == format_search_result(result)


def test_wire_cache_clears_on_data_version_bump(engines):
    _, _, _, port_engine = engines
    storage = port_engine.storage
    cfg = SearchConfig(top_k=3)
    scores, ids = port_engine._fused_fetch(
        port_engine._fused_dispatch_many(QUERIES[:1], None, cfg))
    first = storage.hydrate_wire(scores, ids, cfg)
    assert storage._wire_cache
    stale = int(ids[0][0])
    storage._wire_cache[stale] = b'"chunk_id":"stale"}'
    storage._data_version += 1
    again = storage.hydrate_wire(scores, ids, cfg)
    assert storage._wire_cache[stale] != b'"chunk_id":"stale"}'
    assert again == first


def test_structural_cases(engines, tmp_path):
    _, _, _, port_engine = engines
    cfg = SearchConfig(top_k=3)
    assert port_engine._fused_search_many(QUERIES + ["x"], None, cfg) is None
    assert port_engine._fused_search_many([], None, cfg) == []
    nothing = {"project_name": "no-such-project"}
    assert port_engine._fused_search_many(QUERIES[:2], nothing, cfg) == [
        [], []]
    assert port_engine._fused_search_many(
        QUERIES[:2], None, SearchConfig(top_k=0)) == [[], []]
    hashed = SearchEngine(str(tmp_path / "hash"), model_name="hash-768",
                          use_warm_server=False, device="cpu")
    hashed.index_conversations(write_transcripts(tmp_path))
    assert hashed.storage.index.ntotal > 0
    assert hashed._fused_search_many(QUERIES[:1], None, cfg) is None
    assert hashed.search_conversations(QUERIES[0], top_k=2)  # classic


def test_fused_error_propagates(engines, monkeypatch):
    config, _, _, port_engine = engines

    def broken(*args, **kwargs):
        raise RuntimeError("injected scan fault")

    name = {"ivf": "ivf_scan", "sharded": "sharded_scan",
            "sharded_ivf": "sharded_ivf_scan"}.get(config[0], "flat_scan")
    monkeypatch.setattr(engine_mod, name, broken)
    calls = []
    monkeypatch.setattr(port_engine.storage, "search",
                        lambda *a, **k: calls.append(a) or [])
    with pytest.raises(RuntimeError, match="injected scan fault"):
        port_engine.search_conversations(QUERIES[0], top_k=3)
    with pytest.raises(RuntimeError, match="injected scan fault"):
        port_engine._fused_search_many(QUERIES[:9], None, SearchConfig())
    assert calls == []  # the classic path never ran


def test_concurrent_fused_searches_match_sequential(engines):
    """8 threads dispatch fused windows at once (the warm server's worker
    and in-process searches can overlap), each equal to its query's
    sequential result: tokenization, staging and the program are not
    shared across threads unguarded."""
    import threading

    _, _, _, port_engine = engines
    storage = port_engine.storage
    ids = sorted(storage.chunk_id_to_faiss_id)[:8]
    texts = [storage.get_chunk_by_id(cid).text for cid in ids]
    cfg = SearchConfig(top_k=3)

    def answer(text):
        return [(r.chunk_id, r.similarity) for r in
                port_engine._fused_search_many([text], None, cfg)[0]]

    want = [answer(t) for t in texts]
    wrong = []
    start = threading.Barrier(len(texts))

    def client(i):
        start.wait(timeout=60)
        for _ in range(20):
            got = answer(texts[i])
            if got != want[i]:
                wrong.append((i, got))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []

