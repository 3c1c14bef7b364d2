"""The fused-path cases of ``tests/test_torch_fused_search.py`` on a flat
index sharded over 8 CPU shards (``CLAUDE_SEARCH_SHARD_DEVICES=8``, bf16
and int8; the JAX engine shards alike over its 8 virtual CPU devices;
``tests/test_torch_fused_sharded_ivf.py`` runs them on sharded IVF):
the port's sharded window against its classic path and against the JAX
engine's sharded fused search, after an add and a remove, ``hydrate_wire``,
the structural cases, an error in the sharded scan propagating, and
concurrent windows.  A file of its own, so that a parallel test run gives
these cases a worker of their own.

Added: the same 8 shards reloaded on two mesh devices (``cpu`` and
``cpu:1``, shard by shard in turn), whose fused window takes them as a
plan of two cards and answers as the co-located window, the classic path
and the JAX engine's sharded fused search; and a mesh that gathers across
processes (a one-rank gloo group), whose window takes the shards with the
ranks' gather as a step of its plan and answers as the classic path and
one device (``tests/test_torch_fused_processes.py`` runs two processes).
"""

import contextlib

import pytest

from test_torch_engine import write_model
from test_torch_fused_search import (  # noqa: F401  (collected here too)
    FILTERS,
    QUERIES,
    SIM_EQ,
    TOL,
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
from tpu_search_torch.parallel import ShardedFlatIndex
from tpu_search_torch.storage.hybrid import SearchConfig


@pytest.fixture(scope="module",
                params=sorted(k for k in TOL if k[0] == "sharded"))
def engines(request, tmp_path_factory):
    return make_engines(request.param, tmp_path_factory)


def two_card_mesh(n: int):
    """``n`` shards over two mesh devices, ``cpu`` and ``cpu:1`` in turn:
    each device holds every other shard."""
    import torch

    from tpu_search_torch.parallel import build_mesh

    return build_mesh(n_data=n, devices=[torch.device("cpu", i % 2)
                                         for i in range(n)])


@contextlib.contextmanager
def reloaded_on(storage, mesh, tmp_path):
    """The storage's sharded index saved and loaded onto ``mesh`` for the
    block, then put back."""
    index = storage.index
    path = str(tmp_path / "two_cards.idx")
    index.save(path)
    storage.index = type(index).load(path, mesh=mesh)
    try:
        yield storage.index
    finally:
        storage.index = index


def assert_two_card_window(engine, queries, cfg, plan):
    """The window takes the shards on two cards: it carries the scan's
    card plan, whose cards are the mesh's two devices."""
    from tpu_search_torch.api.fused import Window

    window = engine._fused_window(queries, None, cfg)
    assert isinstance(window, Window) and window.plan is plan
    built = plan(window.scan_key, window.buffers, window.staged, window.k,
                 merge_device=window.device)
    assert [str(d) for d in built.cards] == ["cpu:0", "cpu:1"]
    assert not engine.storage.index.colocated(window.device)


def test_sharded_window_over_two_devices_fuses(engines, tmp_path):
    """The 8 shards reloaded on two mesh devices: the fused window takes
    them (a plan of two cards) and answers as the co-located window and
    the classic path (equal ids, similarities within ``SIM_EQ``) and as
    the JAX engine's sharded fused search (within ``TOL``), at 1, 8 and
    9 queries, unfiltered and filtered."""
    config, _, jax_engine, engine = engines
    cfg = SearchConfig(top_k=5)
    want = {(n, f is None): engine._fused_search_many(QUERIES[:n], f, cfg)
            for n in (1, 8, 9) for f in FILTERS}
    with reloaded_on(engine.storage, two_card_mesh(8), tmp_path):
        assert_two_card_window(engine, QUERIES[:9], cfg,
                               engine_mod.sharded_flat_plan)
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


def test_sharded_window_gathering_across_processes_fuses(tmp_path, caplog):
    """Shards on a mesh that gathers across a process group (here a
    one-rank gloo group): the fused window takes them, a plan whose stage
    gathers the ranks' results, and answers as the classic path and as
    one device; nothing declines or logs that the window serves one
    process."""
    import logging

    import torch.distributed as dist

    from tpu_search_torch.api.fused import Window
    from tpu_search_torch.parallel.sharded_index import gather_ranks

    write_model(tmp_path / "port" / "models")
    engine = SearchEngine(str(tmp_path / "port"), model_name="tiny-mpnet",
                          use_warm_server=False, device="cpu")
    engine.index_conversations(write_transcripts(tmp_path))
    storage = engine.storage
    cfg = SearchConfig(top_k=5)
    want = engine._fused_search_many(QUERIES[:4], None, cfg)
    storage.save_index()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/group",
                            rank=0, world_size=1)
    try:
        storage.index = ShardedFlatIndex.load(str(storage.index_path),
                                              two_card_mesh(2))
        with caplog.at_level(logging.INFO, logger=engine_mod.logger.name):
            window = engine._fused_window(QUERIES[:4], None, cfg)
            assert isinstance(window, Window)
            assert window.plan is engine_mod.sharded_flat_plan
            plan = window.plan(window.scan_key, window.buffers,
                               window.staged, window.k,
                               merge_device=window.device)
            assert [s.collective for s in plan.stages] == [gather_ranks]
            fused = engine._fused_search_many(QUERIES[:4], None, cfg)
        assert "serves one process" not in caplog.text
        assert_equal_results(fused, want)
        assert_equal_results(classic(engine, QUERIES[:4], None, cfg), want)
        got = [engine.search_conversations(q, top_k=5) for q in QUERIES[:4]]
        for results, ref in zip(got, want):
            assert [r["chunk_id"] for r in results] == [
                r.chunk_id for r in ref]
            for a, b in zip(results, ref):
                assert abs(a["similarity"] - b.similarity) <= SIM_EQ
    finally:
        dist.destroy_process_group()
