"""The fused query window across processes: two gloo processes on the CPU,
4 devices each, serving one index sharded over all 8 (process p owns
shards 4p .. 4p + 3).

Each worker joins through ``initialize_distributed`` (a ``file://``
rendezvous, ``test_torch_distributed.run_workers``) and builds a
``SearchEngine(device="cpu")`` on its own data directory, with the tiny
MPNet checkpoint, the same transcripts and ``CLAUDE_SEARCH_SHARD_DEVICES=8``
(the 8 devices of both processes): flat bf16, flat int8, and IVF int4 with
its int8 refine tier (every cluster probed).  After the same add and the
same ``remove_chunks_for_files`` on both ranks, windows of 1, 8, 9 and 32
queries, unfiltered and ``has_code``, go through the fused window (a
``Window`` whose plan gathers the ranks' results), each equal to the
classic path in the same processes (ids, similarities within ``SIM_EQ``).
Then a per-process save (``.host<p>`` files) and fresh engines in the same
processes that load them and answer as before.  The workers import torch
and the port only.

In this process the answers are held against each other (both ranks
alike), against a one-process port engine over 8 shards on the same
corpus after the same writes (the same global shard order: ids equal,
similarities within ``SIM_EQ``), and against the JAX engine's sharded
search on 8 virtual CPU devices within ``TOL`` (its fused search; for the
refined IVF store, which the JAX engine does not fuse, its classic path).
A file of its own, so that a parallel test run gives it a worker.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_distributed import run_workers
from test_torch_engine import write_model
from test_torch_fused_search import (
    FILTERS,
    QUERIES,
    TOL,
    WINDOWS,
    _env,
    assert_close_results,
    assert_equal_results,
    make_engines,
)
from tpu_search.storage.hybrid import SearchConfig as JaxSearchConfig
from tpu_search_torch.storage.hybrid import SearchConfig

WORKER = r"""
import json, sys
from pathlib import Path

pid, rendezvous, root = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
spec = json.loads((root / "spec.json").read_text())

from tpu_search_torch.api.engine import SearchEngine
from tpu_search_torch.api.fused import Window
from tpu_search_torch.parallel import initialize_distributed, process_count
from tpu_search_torch.parallel.sharded_index import gather_ranks
from tpu_search_torch.storage.hybrid import SearchConfig

initialize_distributed(coordinator_address=rendezvous, num_processes=2,
                       process_id=pid)
assert process_count() == 2
data = root / f"rank{pid}"
mine = tuple(range(4 * pid, 4 * pid + 4))


def engine():
    e = SearchEngine(str(data), model_name="tiny-mpnet",
                     use_warm_server=False, device="cpu")
    e._open()
    return e


def check_index(e):
    index = e.storage.index
    assert type(index).__name__ == spec["index"], index
    assert index.mesh.processes == 2 and index.n_shards == 8
    assert index.mesh.local_shards() == mine
    assert tuple(index._shards) == mine


def rows(results):
    return [[[r.chunk_id, r.similarity] for r in rs] for rs in results]


def same(got, want, what):
    assert [[c for c, _ in rs] for rs in got] == [
        [c for c, _ in rs] for rs in want], what
    for a, b in zip(got, want):
        for (_, x), (_, y) in zip(a, b):
            assert abs(x - y) <= 1e-6, (what, x, y)


def answers(e):
    cfg = SearchConfig(top_k=5)
    out = {}
    for n in spec["windows"]:
        for filters in spec["filters"]:
            queries = spec["queries"][:n]
            window = e._fused_window(queries, filters, cfg)
            assert isinstance(window, Window) and window.plan is not None
            plan = window.plan(window.scan_key, window.buffers,
                               window.staged, window.k,
                               merge_device=window.device)
            assert plan.stages[0].collective is gather_ranks
            fused = rows(e._fused_search_many(queries, filters, cfg))
            assert all(fused)
            classic = rows(e.storage.search_many(
                e.embedder._encode_texts(queries), cfg, filters))
            key = f"{n} {filters is None}"
            same(fused, classic, key + " fused vs classic")
            out[key] = fused
    return out


e = engine()
e.index_conversations([Path(p) for p in spec["files"]])
check_index(e)
e.index_conversations([Path(spec["added"])])
assert e.storage.remove_chunks_for_files([spec["removed"]]) > 0
after = answers(e)
e.storage.save_index()
assert Path(f"{e.storage.index_path}.host{pid}").exists()
fresh = engine()  # the same data directory: the per-process files
check_index(fresh)
assert fresh.storage.index is not e.storage.index
loaded = answers(fresh)
for key in after:
    same(loaded[key], after[key], key + " loaded")
(root / f"answers{pid}.json").write_text(json.dumps(after))
assert "jax" not in sys.modules
import torch.distributed
torch.distributed.destroy_process_group()
print(f"FUSED_WORKER_{pid}_OK", flush=True)
"""

CASES = (("sharded", "bfloat16"), ("sharded", "int8"),
         ("sharded_ivf", "int4"))
INDEX = {"sharded": "ShardedFlatIndex", "sharded_ivf": "ShardedIVFIndex"}
# The refined sharded IVF store has no entry of its own in TOL: its scores
# are the int8 refine tier's, as on the one-device IVF int4 store.
JAX_TOL = {**TOL, ("sharded_ivf", "int4"): TOL[("ivf", "int4")]}


def write_added(root):
    """A conversation both ranks (and the engines here) add."""
    path = root / "claude-projects" / "-root-fresh" / "new.jsonl"
    path.parent.mkdir(parents=True)
    text = " ".join(f"tok{(5 * j) % 59}" for j in range(40))
    path.write_text("".join(json.dumps({
        "uuid": f"n{i}", "sessionId": "fresh",
        "timestamp": f"2025-07-03T09:0{i}:00Z",
        "message": {"role": role,
                    "content": [{"type": "text", "text": text}]},
    }) + "\n" for i, role in enumerate(("user", "assistant"))))
    return path


@pytest.fixture(scope="module", params=CASES,
                ids=["_".join(c) for c in CASES])
def processes(request, tmp_path_factory):
    """The JAX engine and a one-process port engine over 8 shards
    (``make_engines``), then the two workers over the same transcripts;
    all after the same add and remove.  ``(config, jax engine, port
    engine, [rank 0's answers, rank 1's])``."""
    config = request.param
    _, root, jax_engine, one = make_engines(config, tmp_path_factory)
    files = [root / "claude-projects" / project / f"{session}.jsonl"
             for project, session in (("-root-myproj", "s1"),
                                      ("-root-myproj", "s2"),
                                      ("-root-other", "s3"))]
    added, removed = write_added(root), str(files[1])
    for engine in (jax_engine, one):
        engine.index_conversations([added])
        assert engine.storage.remove_chunks_for_files([removed]) > 0
    for pid in (0, 1):
        write_model(root / f"rank{pid}" / "models")
    (root / "spec.json").write_text(json.dumps({
        "files": [str(f) for f in files], "added": str(added),
        "removed": removed, "queries": QUERIES, "windows": list(WINDOWS),
        "filters": list(FILTERS), "index": INDEX[config[0]]}))
    env = {**_env(*config), "CLAUDE_SEARCH_SHARD_DEVICES": "8"}
    outs = run_workers(root, WORKER, "fused_worker.py", env=env)
    for pid, out in enumerate(outs):
        assert f"FUSED_WORKER_{pid}_OK" in out
    answers = [json.loads((root / f"answers{pid}.json").read_text())
               for pid in (0, 1)]
    return config, jax_engine, one, answers


def results(rows):
    """A worker's ``[[chunk_id, similarity], ...]`` rows as result-like
    objects for the helpers of ``test_torch_fused_search``."""
    return [[SimpleNamespace(chunk_id=c, similarity=s) for c, s in rs]
            for rs in rows]


def windows():
    for n in WINDOWS:
        for filters in FILTERS:
            yield f"{n} {filters is None}", QUERIES[:n], filters


def test_both_ranks_answer_alike(processes):
    """Rank 0 and rank 1 give every window the same answers."""
    _, _, _, (rank0, rank1) = processes
    assert sorted(rank0) == sorted(rank1) == sorted(k for k, _, _ in
                                                     windows())
    for key in rank0:
        assert_equal_results(results(rank1[key]), results(rank0[key]))


def test_processes_answer_as_one_process(processes):
    """The two processes' 8 shards answer as one process's 8 shards (the
    same global shard order): ids equal, similarities within
    ``SIM_EQ``."""
    _, _, one, (rank0, _) = processes
    cfg = SearchConfig(top_k=5)
    for key, queries, filters in windows():
        want = one._fused_search_many(queries, filters, cfg)
        assert want is not None and all(want)
        assert_equal_results(results(rank0[key]), want)


def test_processes_match_jax(processes):
    """The two processes' answers against the JAX engine's sharded search
    over 8 virtual CPU devices within ``TOL``."""
    config, jax_engine, _, (rank0, _) = processes
    cfg = JaxSearchConfig(top_k=10)
    for key, queries, filters in windows():
        ref = jax_engine._fused_search_many(queries, filters, cfg)
        if ref is None:  # no JAX fused program for the refined store
            ref = jax_engine.storage.search_many(np.stack(
                [jax_engine.embedder.generate_single_embedding(q)
                 for q in queries]), cfg, filters)
        assert_close_results(results(rank0[key]), ref, JAX_TOL[config])
