"""The fused-path cases of ``tests/test_torch_fused_search.py`` on a flat
index sharded over 8 CPU shards (``CLAUDE_SEARCH_SHARD_DEVICES=8``, bf16
and int8; the JAX engine shards alike over its 8 virtual CPU devices;
``tests/test_torch_fused_sharded_ivf.py`` runs them on sharded IVF):
the port's sharded window against its classic path and against the JAX
engine's sharded fused search, after an add and a remove, ``hydrate_wire``,
the structural cases, an error in the sharded scan propagating, and
concurrent windows.  A file of its own, so that a parallel test run gives
these cases a worker of their own.

Added: a sharded index whose shards lie on two different mesh devices:
the fused window declines (logged once) and the classic path answers as
one device does.
"""

import pytest

from test_torch_engine import write_model
from test_torch_fused_search import (  # noqa: F401  (collected here too)
    QUERIES,
    SIM_EQ,
    TOL,
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
from tpu_search_torch.api import engine as engine_mod
from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.storage.hybrid import SearchConfig


@pytest.fixture(scope="module",
                params=sorted(k for k in TOL if k[0] == "sharded"))
def engines(request, tmp_path_factory):
    return make_engines(request.param, tmp_path_factory)


def test_sharded_window_over_two_devices_declines(tmp_path, caplog):
    """Shards on two different mesh devices: the fused window is None
    (logged once) and the classic path answers, equal to one device."""
    import logging

    import torch

    from tpu_search_torch.parallel import ShardedFlatIndex, build_mesh

    write_model(tmp_path / "port" / "models")
    engine = SearchEngine(str(tmp_path / "port"), model_name="tiny-mpnet",
                          use_warm_server=False, device="cpu")
    engine.index_conversations(write_transcripts(tmp_path))
    storage = engine.storage
    cfg = SearchConfig(top_k=5)
    want = engine._fused_search_many(QUERIES[:4], None, cfg)
    storage.save_index()
    mesh = build_mesh(n_data=2, devices=[torch.device("cpu"),
                                         torch.device("cpu", 1)])
    storage.index = ShardedFlatIndex.load(str(storage.index_path), mesh)
    assert not storage.index.colocated(torch.device("cpu"))
    with caplog.at_level(logging.INFO, logger=engine_mod.logger.name):
        assert engine._fused_window(QUERIES[:4], None, cfg) is None
        assert engine._fused_search_many(QUERIES[:1], None, cfg) is None
    assert caplog.text.count("fused query path serves one device") == 1
    got = [engine.search_conversations(q, top_k=5) for q in QUERIES[:4]]
    for results, ref in zip(got, want):
        assert [r["chunk_id"] for r in results] == [r.chunk_id for r in ref]
        for a, b in zip(results, ref):
            assert abs(a["similarity"] - b.similarity) <= SIM_EQ
    assert_equal_results(classic(engine, QUERIES[:4], None, cfg), want)
