"""The fused-path cases of ``tests/test_torch_fused_search.py`` on an IVF
index sharded over 8 CPU shards (``CLAUDE_SEARCH_SHARD_DEVICES=8``,
``CLAUDE_SEARCH_INDEX_TYPE=ivf``, every cluster probed; bf16 and int8):
the port's sharded IVF window (each shard's probe scan and the merge in
one program) against its classic path and against the JAX engine's
sharded fused search, after an add and a remove, ``hydrate_wire``, the
structural cases, an error in the sharded scan propagating, and concurrent
windows.  A file of its own, so that a parallel test run gives these cases
a worker of their own.

Added: a sharded IVF int4 store with its int8 refine tier, whose fused
windows (the probe scans, the merge and the rescore in one program) answer
as its classic path.  The JAX engine has no fused program for that store
(its dispatch knows no ``sharded_ivf_refine`` key and falls back to its
classic path), so that case holds the port to itself.

Added: the same shards reloaded on two mesh devices (``cpu`` and
``cpu:1``, shard by shard in turn), bf16 / int8 and int4 with its refine
tier: the fused window takes them as a plan of two cards (the probe
scans a card, the merge, the rescore a card, the final merge) and answers
as the co-located window and the classic path, and as the JAX engine's
sharded fused search where it has one.
"""

import pytest

from test_torch_engine import write_model
from test_torch_fused_sharded import (
    assert_two_card_window,
    reloaded_on,
    two_card_mesh,
)
from test_torch_fused_search import (  # noqa: F401  (collected here too)
    FILTERS,
    QUERIES,
    TOL,
    _env,
    assert_close_results,
    assert_equal_results,
    classic,
    make_engines,
    test_concurrent_fused_searches_match_sequential,
    test_fused_error_propagates,
    test_fused_matches_classic_and_jax,
    test_fused_sees_an_add_and_a_remove,
    test_hydrate_wire_matches_hydrate_results,
    test_structural_cases,
    test_wire_cache_clears_on_data_version_bump,
)
from test_torch_host_copies import write_transcripts
from tpu_search.storage.hybrid import SearchConfig as JaxSearchConfig
from tpu_search_torch.api import engine as engine_mod
from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.storage.hybrid import SearchConfig


@pytest.fixture(scope="module", params=sorted(
    k for k in TOL if k[0] == "sharded_ivf"))
def engines(request, tmp_path_factory):
    return make_engines(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def refine_engine(tmp_path_factory):
    """A port engine over a sharded IVF int4 store with its int8 refine
    tier on (the quantization auto-config), 8 CPU shards."""
    root = tmp_path_factory.mktemp("fused_sharded_ivf_int4")
    files = write_transcripts(root)
    write_model(root / "port" / "models")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in _env("sharded_ivf", "int4").items():
            mp.setenv(key, value)
        engine = SearchEngine(str(root / "port"), model_name="tiny-mpnet",
                              use_warm_server=False, device="cpu")
    engine.index_conversations(files)
    index = engine.storage.index
    assert type(index).__name__ == "ShardedIVFIndex"
    assert index.refine_dtype == "int8" and index._refine.count
    return engine


def test_sharded_ivf_refine_window_matches_classic(refine_engine):
    """A sharded IVF int4 store (its int8 refine tier on: the quantization
    auto-config) through the fused window at 1 and 9 queries (both query
    paddings), unfiltered and filtered: the scan key carries the refine
    factor and the answers equal the classic path's."""
    engine = refine_engine
    cfg = SearchConfig(top_k=5)
    window = engine._fused_window(QUERIES[:1], None, cfg)
    assert window.scan_key[0] == "sharded_ivf" and window.scan_key[8] > 0
    for filters in FILTERS:
        for size in (1, 9):
            queries = QUERIES[:size]
            fused = engine._fused_search_many(queries, filters, cfg)
            assert fused is not None and all(fused)
            assert_equal_results(fused, classic(engine, queries, filters,
                                                cfg))


def test_sharded_ivf_window_over_two_devices_fuses(engines, tmp_path):
    """The 8 IVF shards reloaded on two mesh devices: the fused window
    takes them (a plan of two cards) and answers as the co-located window
    and the classic path (equal ids, similarities within 1e-6) and as the
    JAX engine's sharded fused search (within ``TOL``)."""
    config, _, jax_engine, engine = engines
    cfg = SearchConfig(top_k=5)
    want = {(n, f is None): engine._fused_search_many(QUERIES[:n], f, cfg)
            for n in (1, 9) for f in FILTERS}
    with reloaded_on(engine.storage, two_card_mesh(8), tmp_path):
        assert_two_card_window(engine, QUERIES[:9], cfg,
                               engine_mod.sharded_ivf_plan)
        for (n, unfiltered), colocated in want.items():
            filters = None if unfiltered else FILTERS[1]
            queries = QUERIES[:n]
            fused = engine._fused_search_many(queries, filters, cfg)
            assert fused is not None and all(fused)
            assert_equal_results(fused, colocated)
            assert_equal_results(fused, classic(engine, queries, filters,
                                                cfg))
            ref = jax_engine._fused_search_many(queries, filters,
                                                JaxSearchConfig(top_k=10))
            assert_close_results(fused, ref, TOL[config])


def test_sharded_ivf_refine_window_over_two_devices_fuses(refine_engine,
                                                          tmp_path):
    """The int4 + int8 refine store's shards reloaded on two mesh devices:
    the window's plan has two stages (the probe scans, then the rescore,
    a card each) and its answers equal the co-located window's and the
    classic path's at 1 and 9 queries, unfiltered and filtered."""
    engine = refine_engine
    cfg = SearchConfig(top_k=5)
    want = {(n, f is None): engine._fused_search_many(QUERIES[:n], f, cfg)
            for n in (1, 9) for f in FILTERS}
    with reloaded_on(engine.storage, two_card_mesh(8), tmp_path) as index:
        assert index._refine.count
        assert_two_card_window(engine, QUERIES[:9], cfg,
                               engine_mod.sharded_ivf_plan)
        window = engine._fused_window(QUERIES[:1], None, cfg)
        assert window.scan_key[8] > 0
        assert len(window.plan(window.scan_key, window.buffers,
                               window.staged, window.k).stages) == 2
        for (n, unfiltered), colocated in want.items():
            filters = None if unfiltered else FILTERS[1]
            queries = QUERIES[:n]
            fused = engine._fused_search_many(queries, filters, cfg)
            assert fused is not None and all(fused)
            assert_equal_results(fused, colocated)
            assert_equal_results(fused, classic(engine, queries, filters,
                                                cfg))
