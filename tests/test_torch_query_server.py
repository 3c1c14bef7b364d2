"""The port's warm query server (``tpu_search_torch/interfaces/
query_server.py``, a verbatim copy of the JAX package's): the cases of
``tests/test_query_server.py`` pointed at the port's modules, with the
port's engine on the CPU (socket protocol, request ids, shutdown
delivery, engine routing, batching, partial failure, pipelined fused
serving, serving over a flat index sharded over 8 CPU shards).  Added:
the port's ``_warm_request`` against a ``QueryServer`` on a JAX engine
returns that engine's local results (one wire protocol, one socket path
for both packages).

Every socket carries a timeout and every thread join a bound.
"""

import json
from unittest.mock import MagicMock

import numpy as np
import pytest

from tpu_search_torch.interfaces.query_server import (
    QueryClient,
    QueryServer,
    request,
    socket_path_for,
)
from tpu_search_torch.storage.hybrid import SearchResult


@pytest.fixture
def engine():
    mock = MagicMock()
    mock.embedder.is_model_loaded = True
    # Not fusable (mock engine): fall through to the classic batch path.
    mock._fused_dispatch_many.return_value = None
    # Not fusable (mock engine): the worker must fall through to the
    # classic embed-batch + search_many path these tests assert on.
    mock._fused_search_many.return_value = None
    mock.embedder._encode_texts.side_effect = lambda texts: np.zeros(
        (len(texts), 4), dtype=np.float32
    )
    hit = [
        SearchResult(
            chunk_id="c1", similarity=0.9, text="hit",
            metadata={"project_name": "p", "session_id": "s",
                      "timestamp": "t", "has_code": False},
        )
    ]
    mock.storage.search.return_value = hit
    mock.storage.search_many.side_effect = lambda embs, cfg, filters: [
        list(hit) for _ in range(len(embs))
    ]
    mock.get_index_stats.return_value = {"total_chunks": 42}
    mock.storage.get_all_projects.return_value = ["alpha"]
    return mock


def _write_transcript(tmp_path):
    claude_dir = tmp_path / "projects" / "-proj"
    claude_dir.mkdir(parents=True)
    lines = []
    for i in range(8):
        text = f"tok{i} tok{i+1} tok{i+2} " * 12
        lines.append(json.dumps({
            "uuid": f"u{i}", "sessionId": "s1",
            "timestamp": f"2025-07-01T09:0{i}:00Z",
            "message": {
                "role": "user" if i % 2 == 0 else "assistant",
                "content": [{"type": "text", "text": text}],
            },
        }))
    (claude_dir / "s1.jsonl").write_text("\n".join(lines) + "\n")
    return claude_dir / "s1.jsonl"


def _real_engine(tmp_path, **storage):
    """The port's engine on the CPU over a tiny random MPNet (the JAX
    test's checkpoint shape, written by the port's converter), with
    ``storage``'s ``StorageConfig`` fields set before it indexes."""
    from tpu_search_torch.api.engine import SearchEngine
    from tpu_search_torch.models.convert import save_checkpoint
    from tpu_search_torch.models.mpnet import MPNetConfig, init_params

    tiny = MPNetConfig(
        vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
        intermediate_size=32, max_position=96,
    )
    vocab = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + [
        f"tok{i}" for i in range(59)
    ]
    model_dir = tmp_path / "models" / "tiny-mpnet"
    model_dir.mkdir(parents=True)
    save_checkpoint(str(model_dir / "model.tpu.npz"),
                    init_params(tiny, seed=0), tiny)
    (model_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")

    engine = SearchEngine(
        data_dir=str(tmp_path), model_name="tiny-mpnet",
        use_warm_server=False, device="cpu",
    )
    for key, value in storage.items():
        setattr(engine.storage.config, key, value)
    engine.index_conversations([str(_write_transcript(tmp_path))])
    return engine


@pytest.fixture
def server(engine, tmp_path):
    server = QueryServer(engine, str(tmp_path))
    server.start()
    yield server
    server.stop()


class TestProtocol:
    def test_ping(self, server, tmp_path):
        response = request(str(tmp_path), {"op": "ping"})
        assert response["ok"] is True
        assert response["model_loaded"] is True

    def test_search_roundtrip(self, server, engine, tmp_path):
        response = request(
            str(tmp_path),
            {"op": "search", "query": "q", "filters": {"has_code": True},
             "top_k": 5},
        )
        assert response["ok"] is True
        assert response["results"][0]["chunk_id"] == "c1"
        assert response["results"][0]["project"] == "p"
        engine.embedder._encode_texts.assert_called_once_with(["q"])
        search_args = engine.storage.search_many.call_args
        assert search_args[0][1].top_k == 5
        assert search_args[0][2] == {"has_code": True}

    def test_persistent_client_streams_requests(self, server, tmp_path):
        """QueryClient keeps ONE connection open across many requests
        (the steady-caller pattern the serving bench headlines)."""
        with QueryClient(str(tmp_path)) as qc:
            for _ in range(3):
                response = qc.search("q", top_k=5)
                assert response["ok"] is True
                assert response["results"][0]["chunk_id"] == "c1"
            assert qc.request({"op": "ping"})["ok"] is True
            sock_before = qc._sock
            assert qc.search("again")["ok"] is True
            assert qc._sock is sock_before  # no reconnect happened

    def test_pipelined_requests_on_one_connection(self, server, tmp_path):
        """The handler never parks on a response event: several requests
        written back-to-back on one connection all get responses (written
        by worker/finisher threads under the per-connection lock)."""
        import socket as socket_mod

        sock = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
        sock.settimeout(30.0)
        sock.connect(str(socket_path_for(str(tmp_path))))
        try:
            n = 4
            payload = b"".join(
                (json.dumps({"op": "search", "query": f"q{i}", "top_k": 3})
                 + "\n").encode()
                for i in range(n)
            )
            sock.sendall(payload)
            buf = b""
            while buf.count(b"\n") < n:
                chunk = sock.recv(65536)
                assert chunk, "server closed before all responses arrived"
                buf += chunk
            responses = [
                json.loads(line)
                for line in buf.decode().strip().splitlines()
            ]
            assert len(responses) == n
            assert all(r["ok"] for r in responses)
        finally:
            sock.close()

    def test_non_object_json_does_not_kill_the_worker(
        self, server, tmp_path
    ):
        """`42` parses as JSON but is not a request: it must get an error
        response AND the worker must keep serving afterwards (a poisoned
        payload once killed the sole dispatch thread, bricking the warm
        server for every client until daemon restart)."""
        import socket as socket_mod

        sock = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
        sock.settimeout(30.0)
        sock.connect(str(socket_path_for(str(tmp_path))))
        try:
            sock.sendall(b'42\n"hi"\n[1,2]\n')
            buf = b""
            while buf.count(b"\n") < 3:
                chunk = sock.recv(65536)
                assert chunk
                buf += chunk
            for line in buf.decode().strip().splitlines():
                response = json.loads(line)
                assert response["ok"] is False
        finally:
            sock.close()
        # The worker survived: real requests still serve.
        assert request(str(tmp_path), {"op": "ping"})["ok"] is True

    def test_malformed_line_gets_error_response(self, server, tmp_path):
        import socket as socket_mod

        sock = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
        sock.settimeout(30.0)
        sock.connect(str(socket_path_for(str(tmp_path))))
        try:
            sock.sendall(b"{not json}\n")
            line = b""
            while not line.endswith(b"\n"):
                chunk = sock.recv(65536)
                assert chunk
                line += chunk
            response = json.loads(line)
            assert response["ok"] is False
            assert "error" in response
        finally:
            sock.close()

    def test_persistent_client_reconnects_after_drop(
        self, engine, tmp_path
    ):
        server = QueryServer(engine, str(tmp_path))
        server.start()
        try:
            qc = QueryClient(str(tmp_path))
            assert qc.search("q")["ok"] is True
            # Kill the server-side connection by bouncing the server.
            server.stop()
            server = QueryServer(engine, str(tmp_path))
            server.start()
            assert qc.search("q2")["ok"] is True  # transparent reconnect
            qc.close()
        finally:
            server.stop()

    def test_stats_and_projects(self, server, tmp_path):
        assert request(str(tmp_path), {"op": "stats"})["stats"][
            "total_chunks"
        ] == 42
        assert request(str(tmp_path), {"op": "projects"})["projects"] == [
            "alpha"
        ]

    def test_unknown_op(self, server, tmp_path):
        response = request(str(tmp_path), {"op": "nope"})
        assert response["ok"] is False

    def test_engine_error_reported(self, server, engine, tmp_path):
        engine.embedder._encode_texts.side_effect = RuntimeError("boom")
        response = request(str(tmp_path), {"op": "search", "query": "q"})
        assert response["ok"] is False
        assert "boom" in response["error"]

    def test_request_without_server_returns_none(self, tmp_path):
        assert request(str(tmp_path / "empty"), {"op": "ping"}) is None

    def test_stale_socket_returns_none(self, tmp_path):
        path = socket_path_for(str(tmp_path))
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()  # plain file, not a socket
        assert request(str(tmp_path), {"op": "ping"}) is None


class TestRequestIds:
    def test_id_echoed_on_success(self, server, tmp_path):
        """A client-supplied ``id`` comes back in the response, so a
        pipelining client can attribute responses even if requests from
        one connection complete out of order (ADVICE r4 medium: fused
        finisher vs classic worker paths don't guarantee FIFO)."""
        response = request(
            str(tmp_path),
            {"op": "search", "query": "q", "top_k": 2, "id": 7},
        )
        assert response["ok"] is True
        assert response["id"] == 7

    def test_id_echoed_on_error(self, server, tmp_path):
        response = request(str(tmp_path), {"op": "nope", "id": "abc"})
        assert response["ok"] is False
        assert response["id"] == "abc"

    def test_pipelined_ids_attribute_responses(self, server, tmp_path):
        import socket as socket_mod

        sock = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
        sock.settimeout(30.0)
        sock.connect(str(socket_path_for(str(tmp_path))))
        try:
            n = 6
            payload = b"".join(
                (json.dumps({"op": "search", "query": f"q{i}",
                             "top_k": 3, "id": i}) + "\n").encode()
                for i in range(n)
            )
            sock.sendall(payload)
            buf = b""
            while buf.count(b"\n") < n:
                chunk = sock.recv(65536)
                assert chunk
                buf += chunk
            got_ids = sorted(
                json.loads(line)["id"]
                for line in buf.decode().strip().splitlines()
            )
            assert got_ids == list(range(n))
        finally:
            sock.close()


class TestShutdownDelivery:
    def test_parked_writer_requests_fail_fast_on_stop(self, engine):
        """Writer-mode requests still parked on the queue when the worker
        stops must be delivered an error (ADVICE r4: they were silently
        dropped, leaking the connection's inflight permit and hanging
        the client to its timeout)."""
        import threading

        from tpu_search_torch.interfaces.query_server import _BatchWorker, _Request

        worker = _BatchWorker(engine)
        release = threading.Event()
        stalled = threading.Event()

        def stall():
            stalled.set()
            release.wait(timeout=30)

        barrier = threading.Thread(
            target=worker.run, args=(stall,), daemon=True
        )
        barrier.start()
        stalled.wait(timeout=10)

        written = []
        req = _Request(
            {"op": "search", "query": "q"}, writer=written.append
        )
        worker.enqueue(req)
        release.set()

        # stop() while the stalled batch may still hold the queue entry:
        # either the worker processes it or the drain fails it — both
        # must DELIVER.
        worker.stop()
        barrier.join(timeout=10)
        assert written, "parked writer request was never delivered"
        assert req.delivered

    def test_enqueue_after_stop_delivers_error(self, engine):
        from tpu_search_torch.interfaces.query_server import _BatchWorker, _Request

        worker = _BatchWorker(engine)
        worker.stop()
        written = []
        req = _Request({"op": "ping"}, writer=written.append)
        worker.enqueue(req)
        assert len(written) == 1
        assert b"shutting down" in written[0]

    def test_finisher_submit_failure_releases_permit(self, engine):
        """If the finisher pool is already shut down when a fused window
        hands off, the requests must get error responses (not hang) and
        the inflight permit must not leak (ADVICE r4 low)."""
        from tpu_search_torch.api.engine import _FusedPending
        from tpu_search_torch.interfaces.query_server import _BatchWorker, _Request

        worker = _BatchWorker(engine)
        try:
            engine._fused_dispatch_many.return_value = _FusedPending(
                packed=None, k_eff=3, q=1
            )
            worker._finisher.shutdown(wait=True)
            req = _Request({"op": "search", "query": "q", "top_k": 3})
            worker._process([req])
            assert req.response["ok"] is False
            assert req.event.is_set()
            # Permit intact: all PIPELINE permits re-acquirable.
            for _ in range(worker.pipeline):
                assert worker._inflight.acquire(timeout=5)
            for _ in range(worker.pipeline):
                worker._inflight.release()
        finally:
            engine._fused_dispatch_many.return_value = None
            worker.stop()


class TestEngineRouting:
    def test_cli_engine_uses_warm_server(self, server, tmp_path):
        """A fresh SearchEngine routes searches through the socket instead of
        loading its own model."""
        from tpu_search_torch.api.engine import SearchEngine

        cli_engine = SearchEngine(
            data_dir=str(tmp_path), model_name="hash-768", device="cpu"
        )
        results = cli_engine.search_conversations("warm path", top_k=3)
        assert results[0]["chunk_id"] == "c1"
        assert not cli_engine.embedder.is_model_loaded  # never loaded locally

    def test_stats_route_warm(self, server, tmp_path):
        """claude-stats must hit the daemon's hot engine, not pay a cold
        storage init (VERDICT r1 weak #8)."""
        from tpu_search_torch.api.engine import SearchEngine

        cli_engine = SearchEngine(
            data_dir=str(tmp_path), model_name="hash-768", device="cpu"
        )
        stats = cli_engine.get_index_stats()
        assert stats == {"total_chunks": 42}
        assert not cli_engine.storage._initialized  # never loaded locally

    def test_daemon_engine_does_not_self_route(self, tmp_path):
        from tpu_search_torch.api.engine import SearchEngine

        engine = SearchEngine(
            data_dir=str(tmp_path),
            model_name="hash-768",
            use_warm_server=False,
            device="cpu",
        )
        assert engine.use_warm_server is False

    def test_engine_reuses_persistent_connection(self, server, tmp_path):
        """A long-lived engine (the MCP-server shape) streams warm-server
        requests down ONE connection instead of reconnecting per call."""
        from tpu_search_torch.api.engine import SearchEngine

        cli_engine = SearchEngine(
            data_dir=str(tmp_path), model_name="hash-768", device="cpu"
        )
        assert cli_engine.search_conversations("q1", top_k=2)
        client = cli_engine._warm_clients.client
        sock = client._sock
        assert sock is not None
        for _ in range(3):
            assert cli_engine.search_conversations("qN", top_k=2)
        assert cli_engine.get_index_stats() == {"total_chunks": 42}
        assert cli_engine._warm_clients.client is client
        assert client._sock is sock  # no reconnect happened

    def test_engine_falls_back_local_when_no_server(self, tmp_path):
        """With no daemon listening the warm route returns None and the
        engine serves locally (existing behavior, now via QueryClient)."""
        from tpu_search_torch.api.engine import SearchEngine

        cli_engine = SearchEngine(
            data_dir=str(tmp_path), model_name="hash-768", device="cpu"
        )
        assert cli_engine._warm_request({"op": "ping"}) is None


class TestBatching:
    def test_concurrent_searches_batched(self, server, engine, tmp_path):
        """Concurrent requests arriving together must share embed batches
        and all receive correct responses. The worker is stalled on a
        barrier task while the clients enqueue, so the batch window is
        deterministic regardless of machine load."""
        import threading

        n_clients = 12
        responses = [None] * n_clients
        release = threading.Event()
        stalled = threading.Event()

        def stall():
            stalled.set()
            release.wait(timeout=60)

        worker = server._worker
        barrier = threading.Thread(target=worker.run, args=(stall,))
        barrier.start()
        stalled.wait(timeout=10)

        def client(i):
            responses[i] = request(
                str(tmp_path), {"op": "search", "query": f"q{i}", "top_k": 2}
            )

        threads = [
            threading.Thread(target=client, args=(i,))
            for i in range(n_clients)
        ]
        for t in threads:
            t.start()
        # All clients must be parked on the queue before the worker wakes.
        import time

        deadline = time.monotonic() + 60
        while worker.queue.qsize() < n_clients:
            assert time.monotonic() < deadline, "clients never queued"
            time.sleep(0.001)
        release.set()
        barrier.join(timeout=60)
        for t in threads:
            t.join(timeout=60)

        assert all(r is not None and r["ok"] for r in responses)
        assert all(r["results"][0]["chunk_id"] == "c1" for r in responses)
        embed_calls = engine.embedder._encode_texts.call_args_list
        total_texts = sum(len(c[0][0]) for c in embed_calls)
        assert total_texts == n_clients
        # the queued-up requests must share one embed batch ...
        assert len(embed_calls) == 1
        # ... and (same top_k, no filters) ONE batched index scan
        scan_calls = engine.storage.search_many.call_args_list
        assert len(scan_calls) == 1
        assert len(scan_calls[0][0][0]) == n_clients


class TestPartialBatchFailure:
    def test_completed_group_responses_survive_later_failure(self, engine):
        """If _run_searches dies midway, requests whose responses were
        already written must keep them (ADVICE.md round 1)."""
        from tpu_search_torch.interfaces.query_server import _BatchWorker, _Request

        worker = _BatchWorker(engine)
        ok_req = _Request({"op": "search", "query": "a"})
        bad_req = _Request({"op": "search", "query": "b"})

        def boom(searches):
            ok_req.response = {"ok": True, "results": []}
            raise RuntimeError("group two exploded")

        worker._run_searches = boom
        worker._process([ok_req, bad_req])

        assert ok_req.response == {"ok": True, "results": []}
        assert bad_req.response["ok"] is False
        assert "exploded" in bad_req.response["error"]
        assert ok_req.event.is_set() and bad_req.event.is_set()


class TestPipelinedFusedServing:
    """Round-3 serving pipeline: fused windows dispatch on the worker
    thread and are fetched/hydrated by the finisher pool — concurrent
    clients must all get CORRECT per-query results (no cross-wiring), and
    a mutation op must barrier behind in-flight fetches."""

    @pytest.fixture
    def real_engine(self, tmp_path):
        return _real_engine(tmp_path)

    def test_concurrent_fused_results_not_crosswired(
        self, real_engine, tmp_path
    ):
        import threading

        server = QueryServer(real_engine, str(tmp_path))
        server.start()
        try:
            # ground truth per query via the direct engine path
            queries = [f"tok{i} tok{i+1} tok{i+2}" for i in range(6)]
            expected = {
                q: real_engine.search_conversations(q, top_k=2)[0][
                    "chunk_id"
                ]
                for q in queries
            }
            responses = {}
            lock = threading.Lock()

            def client(q):
                r = request(
                    str(tmp_path),
                    {"op": "search", "query": q, "top_k": 2},
                    timeout=120.0,
                )
                with lock:
                    responses[q] = r

            for _ in range(2):  # two rounds: warm + pipelined
                responses.clear()
                threads = [
                    threading.Thread(target=client, args=(q,))
                    for q in queries
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in threads)
            for q in queries:
                r = responses[q]
                assert r and r.get("ok"), r
                assert r["results"][0]["chunk_id"] == expected[q], q
        finally:
            server.stop()

    def test_wire_fast_path_matches_classic(
        self, real_engine, tmp_path, monkeypatch
    ):
        """The pre-serialized wire fast path must produce responses that
        parse identically to the classic dict path (key ORDER may differ;
        JSON clients cannot observe it)."""
        import tpu_search_torch.interfaces.query_server as qs_mod

        def fetch(query):
            server = QueryServer(real_engine, str(tmp_path))
            server.start()
            try:
                r = request(
                    str(tmp_path),
                    {"op": "search", "query": query, "top_k": 3, "id": 5},
                    timeout=120.0,
                )
                assert r and r.get("ok"), r
                return r
            finally:
                server.stop()

        query = "tok1 tok2 tok3"
        monkeypatch.setattr(qs_mod, "_WIRE_ENABLED", True)
        wire = fetch(query)
        monkeypatch.setattr(qs_mod, "_WIRE_ENABLED", False)
        classic = fetch(query)
        assert wire["id"] == classic["id"] == 5
        assert len(wire["results"]) == len(classic["results"]) > 0
        for a, b in zip(wire["results"], classic["results"]):
            assert set(a) == set(b)  # same key set
            assert a["chunk_id"] == b["chunk_id"]
            assert a["similarity"] == pytest.approx(b["similarity"])
            assert a["text"] == b["text"]
            assert a["metadata"] == b["metadata"]
            assert a["project"] == b["project"]
            assert a["has_code"] == b["has_code"]

    def test_wire_cache_invalidated_by_mutation(self, real_engine):
        """A reindex that changes a row must not serve stale cached wire
        fragments."""
        storage = real_engine.storage
        cfg_version = storage._data_version
        import numpy as np

        # Prime the cache through hydrate_wire on a real scan.
        emb = real_engine.embedder._encode_texts(["tok1 tok2 tok3"])
        from tpu_search_torch.storage.hybrid import SearchConfig

        scores, ids = storage.index.search(
            np.asarray(emb, np.float32), k=3
        )
        frags = storage.hydrate_wire(scores, ids, SearchConfig(top_k=3))
        assert frags and frags[0]
        assert storage._wire_cache
        # Any mutation bumps the version; next hydrate self-clears.
        storage._data_version += 1
        assert storage._data_version != cfg_version
        frags2 = storage.hydrate_wire(scores, ids, SearchConfig(top_k=3))
        assert [json.loads(b"".join([f]).decode()) for f in frags2[0]] == [
            json.loads(b"".join([f]).decode()) for f in frags[0]
        ]

    def test_mutation_barriers_behind_inflight_fetches(self, real_engine):
        from tpu_search_torch.interfaces.query_server import _BatchWorker

        worker = _BatchWorker(real_engine)
        try:
            r = worker.submit(
                {"op": "search", "query": "tok1 tok2", "top_k": 1},
                timeout=120.0,
            )
            assert r.get("ok"), r
            # a __local__ op (the watcher reindex path) must run after the
            # finisher pool drains — smoke that it completes and returns
            assert worker.run(lambda: 42) == 42
        finally:
            worker.stop()


class TestShardedServing:
    """Warm server -> UDS socket -> HybridStorage sharded over 8 CPU
    shards: the same QueryServer code over a ShardedFlatIndex, each
    window one fused program (the encode, the 8 shard scans, the merge)."""

    @pytest.fixture
    def sharded_engine(self, tmp_path):
        from tpu_search_torch.api.fused import Window
        from tpu_search_torch.parallel.sharded_index import ShardedFlatIndex
        from tpu_search_torch.storage.hybrid import SearchConfig

        engine = _real_engine(tmp_path, shard_devices=8,
                              storage_dtype="float32")
        assert isinstance(engine.storage.index, ShardedFlatIndex)
        assert engine.storage.index.n_shards == 8
        window = engine._fused_window(["tok1 tok2"], None,
                                      SearchConfig(top_k=3))
        assert isinstance(window, Window)
        assert window.scan_key[0] == "sharded_flat"
        return engine

    def test_socket_search_over_sharded_index(
        self, sharded_engine, tmp_path
    ):
        server = QueryServer(sharded_engine, str(tmp_path))
        server.start()
        try:
            queries = [f"tok{i} tok{i+1} tok{i+2}" for i in range(4)]
            # Ground truth from the in-process path on the same engine.
            expected = {
                q: [
                    r["chunk_id"]
                    for r in sharded_engine.search_conversations(q, top_k=3)
                ]
                for q in queries
            }
            for q in queries:
                response = request(
                    str(tmp_path),
                    {"op": "search", "query": q, "top_k": 3, "id": q},
                    timeout=240.0,
                )
                assert response and response.get("ok"), response
                assert response["id"] == q
                got = [r["chunk_id"] for r in response["results"]]
                assert got == expected[q], (q, got, expected[q])
        finally:
            server.stop()


class TestCrossPackage:
    def test_port_client_against_a_jax_server(self, tmp_path):
        """One protocol and one socket path: the port's engine routes its
        searches and stats to a warm server on a JAX engine and returns
        that engine's local results."""
        import jax

        from tpu_search.api.engine import SearchEngine as JaxSearchEngine
        from tpu_search.interfaces.query_server import (
            QueryServer as JaxQueryServer,
        )
        from tpu_search.models import MPNetConfig, init_params
        from tpu_search.models.convert import save_checkpoint
        from tpu_search_torch.api.engine import SearchEngine

        tiny = MPNetConfig(
            vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position=96,
        )
        vocab = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + [
            f"tok{i}" for i in range(59)
        ]
        model_dir = tmp_path / "models" / "tiny-mpnet"
        model_dir.mkdir(parents=True)
        save_checkpoint(str(model_dir / "model.tpu.npz"),
                        init_params(tiny, jax.random.PRNGKey(0)), tiny)
        (model_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
        jax_engine = JaxSearchEngine(
            data_dir=str(tmp_path), model_name="tiny-mpnet",
            use_warm_server=False,
        )
        jax_engine.storage.config.device = "cpu"
        jax_engine.embedder.config.device = "cpu"
        jax_engine.index_conversations([str(_write_transcript(tmp_path))])
        queries = ["tok1 tok2 tok3", "tok4 tok5"]
        local = {q: jax_engine.search_conversations(q, top_k=3)
                 for q in queries}

        server = JaxQueryServer(jax_engine, str(tmp_path))
        server.start()
        try:
            port_engine = SearchEngine(
                data_dir=str(tmp_path), model_name="hash-768", device="cpu"
            )
            response = port_engine._warm_request(
                {"op": "search", "query": queries[0], "top_k": 3})
            assert response["ok"] is True
            for q in queries:
                got = port_engine.search_conversations(q, top_k=3)
                assert [r["chunk_id"] for r in got] == [
                    r["chunk_id"] for r in local[q]]
                assert [r["similarity"] for r in got] == pytest.approx(
                    [r["similarity"] for r in local[q]], abs=1e-6)
            assert port_engine.get_index_stats()["total_chunks"] == (
                jax_engine.get_index_stats()["total_chunks"])
            assert not port_engine.embedder.is_model_loaded
            assert not port_engine.storage._initialized
            port_engine._warm_clients.client.close()
        finally:
            server.stop()
