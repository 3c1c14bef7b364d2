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
"""

import pytest

from test_torch_engine import write_model
from test_torch_fused_search import (  # noqa: F401  (collected here too)
    FILTERS,
    QUERIES,
    TOL,
    _env,
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
from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.storage.hybrid import SearchConfig


@pytest.fixture(scope="module", params=sorted(
    k for k in TOL if k[0] == "sharded_ivf"))
def engines(request, tmp_path_factory):
    return make_engines(request.param, tmp_path_factory)


def test_sharded_ivf_refine_window_matches_classic(tmp_path_factory):
    """A sharded IVF int4 store (its int8 refine tier on: the quantization
    auto-config) through the fused window at 1 and 9 queries (both query
    paddings), unfiltered and filtered: the scan key carries the refine
    factor and the answers equal the classic path's."""
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
