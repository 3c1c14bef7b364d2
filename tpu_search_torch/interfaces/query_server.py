"""Warm query server over a Unix domain socket.

Cold-start fix (SURVEY.md section 7 "hard parts"): the reference reloads the
model and index on every CLI invocation (src/cli.py:237-241); with XLA
compiles in the path that would be worse.  The watcher daemon therefore
doubles as a query server: it already holds a warm engine (model + index +
compiled graphs), listens on ``<data_dir>/query.sock``, and serves searches
in a few ms.  The CLI transparently uses the socket when present and falls
back to a local engine otherwise — no behavior change, only latency.

Protocol: one JSON object per line, one response line per request.
Ops: ping, search, get_chunk, stats, projects.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import socketserver
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = ["QueryServer", "QueryClient", "request", "socket_path_for"]

REQUEST_TIMEOUT_S = 30.0

# Serving fast path (pre-serialized result fragments assembled by byte
# joins instead of per-response dict building + json.dumps).  On by
# default; CLAUDE_SEARCH_WIRE=0 falls back to the classic dict path.
_WIRE_ENABLED = os.environ.get("CLAUDE_SEARCH_WIRE", "1") != "0"


def socket_path_for(data_dir: str) -> Path:
    return Path(data_dir).expanduser() / "query.sock"


class _Request:
    """One in-flight request parked on the worker queue.

    Two delivery modes: socket requests carry a ``writer`` (the response
    is written straight to the connection by whichever worker/finisher
    thread completes it — the handler thread never parks on an event),
    in-process requests (:meth:`_BatchWorker.submit`/``run``) use the
    event."""

    __slots__ = (
        "payload", "event", "response", "fn", "handed", "writer",
        "delivered", "rid", "wire",
    )

    def __init__(self, payload: Dict[str, Any], fn=None, writer=None) -> None:
        self.payload = payload
        self.event = threading.Event()
        self.response: Dict[str, Any] = {}
        self.fn = fn
        self.handed = False  # owned by the finisher pool from here on
        self.writer = writer
        self.delivered = False
        # Client-supplied request id, echoed back in the response so a
        # pipelining client can attribute responses even if two requests
        # from one connection complete out of order (requests landing in
        # different filter groups can take the fused-finisher path and
        # the classic worker path respectively).
        self.rid = payload.get("id") if isinstance(payload, dict) else None
        # Pre-encoded response body (the serving fast path: hydrated
        # results arrive as serialized fragments and never exist as
        # Python dicts).  Mutually exclusive with ``response``.
        self.wire: Optional[bytes] = None

    def deliver(self) -> None:
        """Send the response to the caller exactly once.

        The once-guard matters for the writer mode: a double event.set()
        is harmless, a double socket write would desequence the
        connection's response stream.  Delivery sites don't overlap
        across threads (``handed`` hands ownership to exactly one
        finisher job), so a plain flag suffices."""
        if self.delivered:
            return
        self.delivered = True
        if self.writer is None:
            self.event.set()
            return
        self.writer(encode_response(
            self.response or {"ok": False, "error": "no response"},
            rid=self.rid, wire=self.wire,
        ))


def encode_response(
    response: Dict[str, Any],
    rid: object = None,
    wire: Optional[bytes] = None,
) -> bytes:
    """Serialize one wire response line (compact separators: ~12% fewer
    bytes serialized AND written per response — this path runs at
    thousands of responses/s on one host core and the default ", "/": "
    padding is pure overhead on a wire only json.loads ever reads).

    ``wire`` is an already-encoded JSON object body (the fast path);
    ``rid`` splices the echoed request id in as the first key."""
    body = (
        wire
        if wire is not None
        else json.dumps(response, separators=(",", ":")).encode("utf-8")
    )
    if rid is not None:
        encoded_id = json.dumps(rid, separators=(",", ":")).encode("utf-8")
        if body == b"{}":
            body = b'{"id":%s}' % encoded_id
        else:
            body = b'{"id":%s,%s' % (encoded_id, body[1:])
    return body + b"\n"


class _BatchWorker:
    """Single DISPATCH thread owning all engine mutation/tokenizer access,
    plus a small finisher pool that overlaps result fetches.

    Serializing dispatch through one thread removes SQLite-write/engine/
    tokenizer thread races, and concurrent searches arriving within the
    batching window share ONE device dispatch (the fused path). The
    expensive part of a window on a high-latency host link is the result
    FETCH (one round trip each): fused windows hand their in-flight
    device output to the finisher pool, so while window N's fetch is on
    the wire the worker is already tokenizing and dispatching window N+1
    — up to PIPELINE windows overlap. Window: whatever is queued when
    the worker frees up — no added latency for a lone request.
    """

    MAX_BATCH = 32
    # In-flight fetch/hydrate jobs. Deeper pipelines shave the queue wait
    # behind each result fetch on high-latency host links (each fetch is
    # one round trip; N of them overlap); the device output parked per
    # job is one packed [Q, 2k] float32 — tiny — so the practical bound
    # is host threads contending for CPU. Measured on the bench rig
    # (1M x 768, single host core): depth 8 beats 4 by ~20-40% at every
    # client count (c8 201 vs 146 qps, c32 567 vs ~480), depth 16 is
    # WORSE than 8 everywhere (thread contention). Deployments tune via
    # env.
    PIPELINE = max(1, int(os.environ.get("CLAUDE_SEARCH_QS_PIPELINE", "8")))

    def __init__(self, engine) -> None:
        import concurrent.futures

        self.engine = engine
        self.pipeline = type(self).PIPELINE
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._finisher = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.pipeline, thread_name_prefix="qs-finish"
        )
        self._inflight = threading.Semaphore(self.pipeline)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self.queue.put(None)  # wake the worker
        self._thread.join(timeout=10.0)
        self._finisher.shutdown(wait=False)
        # Writer-mode requests enqueued around shutdown would otherwise
        # never be delivered (the loop exits at the None sentinel): their
        # per-connection inflight permits leak and the client hangs to
        # its timeout.  Fail everything still parked.
        self._drain_queue_with_error()

    def _drain_queue_with_error(self) -> None:
        while True:
            try:
                request = self.queue.get_nowait()
            except queue.Empty:
                return
            if request is None:
                continue
            request.response = {"ok": False, "error": "server shutting down"}
            request.deliver()

    def _drain_inflight(self) -> None:
        """Barrier: wait for every in-flight fetch/hydrate to finish.

        Called before non-search ops (reindex and other engine mutations
        run via :meth:`run`) so a mutation never overlaps a fetch that
        hydrates against pre-mutation metadata."""
        for _ in range(self.pipeline):
            self._inflight.acquire()
        for _ in range(self.pipeline):
            self._inflight.release()

    def enqueue(self, request: _Request) -> None:
        """Queue a writer-carrying request; delivery happens on whichever
        worker/finisher thread completes it (the caller doesn't wait)."""
        if not self._running:
            # A handler thread can race stop(): fail fast instead of
            # parking the request on a queue nobody drains.  (stop()'s
            # post-join drain closes the remaining check-then-put gap.)
            request.response = {"ok": False, "error": "server shutting down"}
            request.deliver()
            return
        self.queue.put(request)

    def submit(
        self, payload: Dict[str, Any], timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        request = _Request(payload)
        self.queue.put(request)
        # Module attr read at call time so deployments can raise it (the
        # FIRST query after a cold daemon start may sit behind an XLA
        # compile far longer than a steady-state search).
        request.event.wait(
            timeout=REQUEST_TIMEOUT_S if timeout is None else timeout
        )
        return request.response or {"ok": False, "error": "worker timeout"}

    def run(self, fn):
        """Execute ``fn()`` ON the worker thread and return its result.

        Used by the watcher's reindex path so indexing and searches share
        one thread — concurrent engine access from the debounce Timer
        thread would race the searches otherwise (shared SQLite
        connection, index buffer swaps, tokenizer scratch buffer).
        """
        request = _Request({"op": "__local__"}, fn=fn)
        self.queue.put(request)
        request.event.wait()  # indexing can take minutes; no timeout
        response = request.response
        if not response.get("ok"):
            raise RuntimeError(response.get("error", "worker failure"))
        return response["value"]

    # -- worker side ---------------------------------------------------------

    def _loop(self) -> None:
        while self._running:
            first = self.queue.get()
            if first is None:
                return
            batch = [first]
            while len(batch) < self.MAX_BATCH:
                try:
                    nxt = self.queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                batch.append(nxt)
            try:
                self._process(batch)
            except Exception as exc:  # noqa: BLE001
                # The sole dispatch thread must NEVER die: a poisoned
                # request would otherwise brick the warm server for
                # every client until a daemon restart.  Fail the batch,
                # keep serving.
                logger.exception("worker batch failed")
                for request in batch:
                    if not request.response and not request.handed:
                        request.response = {"ok": False, "error": str(exc)}
                    if not request.handed:
                        request.deliver()

    def _process(self, batch: List[_Request]) -> None:
        searches = [r for r in batch if r.payload.get("op") == "search"]
        others = [r for r in batch if r.payload.get("op") != "search"]
        if searches:
            try:
                self._run_searches(searches)
            except Exception as exc:
                # Only fail requests that have no response yet AND were
                # not handed to the finisher pool (their fetch may still
                # succeed); earlier filter groups may have completed
                # before the raise.
                for request in searches:
                    if not request.response and not request.handed:
                        request.response = {"ok": False, "error": str(exc)}
        if others:
            self._drain_inflight()
        for request in others:
            try:
                if request.payload.get("op") == "__local__":
                    request.response = {"ok": True, "value": request.fn()}
                else:
                    request.response = _dispatch_simple(
                        self.engine, request.payload
                    )
            except Exception as exc:
                request.response = {"ok": False, "error": str(exc)}
        for request in batch:
            if not request.handed:  # pipelined ones respond when fetched
                request.deliver()

    def _run_searches(self, searches: List[_Request]) -> None:
        import numpy as np

        from ..storage.hybrid import SearchConfig

        engine = self.engine
        if not engine.embedder.is_model_loaded:
            engine.embedder.load_model()
        engine._sync_embedding_dim()
        engine.storage.initialize()

        # Group by (filters, top_k, rerank): each group's predicate mask
        # and top-k shape are identical, so the whole group runs as ONE
        # device scan (the corpus read amortizes over the group). Rerank
        # requests over-fetch k*factor in stage 1, so they group apart.
        groups: Dict[str, List[_Request]] = {}
        for request in searches:
            payload = request.payload
            key = json.dumps(
                [payload.get("filters") or None, payload.get("top_k", 10),
                 payload.get("rerank") or None],
                sort_keys=True,
            )
            groups.setdefault(key, []).append(request)

        def respond(members, results_per_query):
            for request, results in zip(members, results_per_query):
                request.response = {
                    "ok": True,
                    "results": self._finalize(request, results),
                }

        # Fused fast path: tokenize host-side and run encode+scan+top-k as
        # ONE device dispatch per <=8-query group (the hot serving shape —
        # on a high-latency host link this halves the per-window round
        # trips vs embed-then-scan). Larger windows and non-fusable
        # configurations take the classic two-dispatch batch path below.
        from ..api.engine import rerank_fetch_k

        pending: Dict[str, List[_Request]] = {}
        for key, members in groups.items():
            filters, top_k, rerank_spec = json.loads(key)
            fetch_k = (
                rerank_fetch_k(top_k, rerank_spec) if rerank_spec else top_k
            )
            cfg = SearchConfig(
                top_k=fetch_k, include_metadata=True, include_text=True,
                nprobe=getattr(engine, "_default_nprobe", 0),
            )
            if len(members) <= 32:
                dispatched = engine._fused_dispatch_many(
                    [r.payload.get("query", "") for r in members],
                    filters,
                    cfg,
                )
                if isinstance(dispatched, list):  # degenerate: no matches
                    respond(members, dispatched)
                    for request in members:
                        request.deliver()
                    continue
                from ..api.engine import _FusedPending

                if isinstance(dispatched, _FusedPending):
                    # Hand the in-flight device output to the finisher
                    # pool; the worker moves on to the next window while
                    # this fetch rides the host link.  Mark handed only
                    # once the submit SUCCEEDS: a finisher pool shut down
                    # mid-request would otherwise orphan the requests
                    # (no delivery path ever fires) and leak the
                    # acquired inflight permit.
                    self._inflight.acquire()
                    try:
                        for request in members:
                            request.handed = True
                        self._finisher.submit(
                            self._finish_fused, members, dispatched, cfg
                        )
                    except Exception as exc:
                        self._inflight.release()
                        for request in members:
                            request.handed = False
                            request.response = {
                                "ok": False, "error": str(exc),
                            }
                        # _process's final loop delivers (handed=False).
                    continue
            pending[key] = members
        if not pending:
            return

        # Classic path: ONE device embed batch for every remaining query,
        # then one scan per filter group.
        remaining = [r for members in pending.values() for r in members]
        texts = [r.payload.get("query", "") for r in remaining]
        embeddings = {
            id(r): e
            for r, e in zip(remaining, engine.embedder._encode_texts(texts))
        }
        for key, members in pending.items():
            filters, top_k, rerank_spec = json.loads(key)
            fetch_k = (
                rerank_fetch_k(top_k, rerank_spec) if rerank_spec else top_k
            )
            results_per_query = engine.storage.search_many(
                np.stack([embeddings[id(r)] for r in members]),
                SearchConfig(
                    top_k=fetch_k, include_metadata=True, include_text=True,
                    nprobe=getattr(engine, "_default_nprobe", 0),
                ),
                filters,
            )
            respond(members, results_per_query)

    def _finalize(self, request: _Request, results) -> List[Dict[str, Any]]:
        """SearchResults -> wire dicts, applying the request's optional
        cross-encoder rerank (the reranker lives on the engine, so its
        model/compiled graphs stay warm across requests like everything
        else in this process)."""
        from ..api.engine import format_search_result

        payload = request.payload
        formatted = [format_search_result(r) for r in results]
        spec = payload.get("rerank")
        if spec:
            formatted = self.engine.rerank_results(
                payload.get("query", ""),
                formatted,
                int(payload.get("top_k", 10)),
                model=spec.get("model") if isinstance(spec, dict) else None,
            )
        return formatted

    def _finish_fused(self, members, dispatched, cfg) -> None:
        """Finisher-pool side: fetch the packed device result, hydrate,
        respond.  SQLite reads here are safe: the stdlib sqlite3 module is
        serialized (threadsafety 3) and mutations are barriered behind
        :meth:`_drain_inflight` on the dispatch thread.

        Fast path: when every member writes straight to a socket and none
        reranks, results hydrate as PRE-SERIALIZED JSON fragments
        (``HybridStorage.hydrate_wire``'s per-row byte cache) and the
        response body is assembled by byte joins — the per-response
        dict-building + ``json.dumps`` of ~top_k full chunk texts was the
        measured host-core serving ceiling (response-size-proportional,
        benchmarks/results/bench_r4_validation.md)."""
        try:
            if _WIRE_ENABLED and all(
                r.writer is not None and not r.payload.get("rerank")
                for r in members
            ):
                frags_per_query = self.engine._fused_collect_wire(
                    dispatched, cfg
                )
                for request, frags in zip(members, frags_per_query):
                    request.wire = (
                        b'{"ok":true,"results":[' + b",".join(frags) + b"]}"
                    )
            else:
                results_per_query = self.engine._fused_collect(
                    dispatched, cfg
                )
                for request, results in zip(members, results_per_query):
                    request.response = {
                        "ok": True,
                        "results": self._finalize(request, results),
                    }
        except Exception as exc:
            for request in members:
                if not request.response and request.wire is None:
                    request.response = {"ok": False, "error": str(exc)}
        finally:
            self._inflight.release()
            for request in members:
                request.deliver()


class _Handler(socketserver.StreamRequestHandler):
    """Line-oriented connection handler with decoupled response writes.

    The handler thread ONLY reads: each request is enqueued with a
    writer closure, and whichever worker/finisher thread completes it
    writes the response straight to the connection under a
    per-connection lock.  At high concurrency this halves the thread
    wakeups per request and leaves N handler threads blocked in the
    socket read (cheap) instead of parked on response events (GIL
    wakeup storms — the c128 regression, VERDICT r3 item 5).

    A pipelining client should tag each request with an ``id`` field —
    it is echoed back as the response's first key, so responses can be
    attributed even when requests from one connection land in different
    filter groups and complete out of order (one on the fused finisher
    path, one on the classic worker path).  Without ids a client must
    await each response before sending the next (what ``QueryClient``
    does); the per-connection in-flight cap below bounds the damage if
    one doesn't.
    """

    MAX_CONN_INFLIGHT = 64

    def handle(self) -> None:
        worker = self.server.worker  # type: ignore[attr-defined]
        write_lock = threading.Lock()
        inflight = threading.BoundedSemaphore(self.MAX_CONN_INFLIGHT)

        def writer(data: bytes) -> None:
            try:
                with write_lock:
                    self.wfile.write(data)
                    self.wfile.flush()
            except Exception:
                pass  # client went away; the request is already done
            finally:
                inflight.release()

        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            inflight.acquire()
            try:
                req = json.loads(raw)
            except Exception as exc:
                writer(encode_response({"ok": False, "error": str(exc)}))
                continue
            if not isinstance(req, dict):
                # `42` or `"hi"` parse fine but are not requests; without
                # this check they reach the worker and die there instead
                # of here.
                writer(encode_response(
                    {"ok": False, "error": "request must be a JSON object"}
                ))
                continue
            worker.enqueue(_Request(req, writer=writer))


def _dispatch_simple(engine, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "ping":
            return {
                "ok": True,
                "pid": os.getpid(),
                "model_loaded": engine.embedder.is_model_loaded,
            }
        if op == "get_chunk":
            engine.storage.initialize()
            chunk = engine.storage.get_chunk_by_id(req.get("chunk_id", ""))
            if chunk is None:
                return {"ok": True, "chunk": None}
            data = engine.storage._get_chunk_data(chunk.id) or {}
            return {
                "ok": True,
                "chunk": {
                    "id": chunk.id,
                    "text": chunk.text,
                    "metadata": chunk.metadata,
                    "row": {
                        k: data.get(k)
                        for k in (
                            "project_name",
                            "session_id",
                            "timestamp",
                            "has_code",
                        )
                    },
                },
            }
        if op == "stats":
            return {"ok": True, "stats": engine.get_index_stats()}
        if op == "projects":
            engine.storage.initialize()
            return {"ok": True, "projects": engine.storage.get_all_projects()}
        return {"ok": False, "error": f"unknown op: {op}"}


class _UnixServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True
    # Default backlog (5) refuses connections under concurrent client
    # bursts — the whole point of the warm server is many simultaneous
    # short-lived callers.
    request_queue_size = 128

    # ``shutdown()`` only stops the accept loop; handler threads keep
    # serving established (long-lived QueryClient) connections against a
    # worker that has already stopped.  Track live connections so
    # ``stop()`` can sever them — clients see EOF and reconnect.
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._active_conns: set = set()
        self._active_lock = threading.Lock()

    def get_request(self):
        request, addr = super().get_request()
        with self._active_lock:
            self._active_conns.add(request)
        return request, addr

    def shutdown_request(self, request) -> None:
        with self._active_lock:
            self._active_conns.discard(request)
        super().shutdown_request(request)

    def close_active_connections(self) -> None:
        with self._active_lock:
            conns = list(self._active_conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class QueryServer:
    """Serves a warm engine over ``<data_dir>/query.sock``."""

    def __init__(self, engine, data_dir: str) -> None:
        self.engine = engine
        self.socket_path = socket_path_for(data_dir)
        self._server: Optional[_UnixServer] = None
        self._thread: Optional[threading.Thread] = None
        self._worker: Optional[_BatchWorker] = None

    def start(self) -> None:
        if self.socket_path.exists():
            self.socket_path.unlink()
        self.socket_path.parent.mkdir(parents=True, exist_ok=True)
        self._server = _UnixServer(str(self.socket_path), _Handler)
        self._worker = _BatchWorker(self.engine)
        self._server.worker = self._worker  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("Query server listening on %s", self.socket_path)

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.stop()
            self._worker = None
        if self._server is not None:
            self._server.shutdown()
            self._server.close_active_connections()
            self._server.server_close()
            self._server = None
        if self.socket_path.exists():
            try:
                self.socket_path.unlink()
            except OSError:
                pass

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class QueryClient:
    """Persistent-connection client for the warm server.

    :func:`request` opens a fresh connection per call — right for
    one-shot CLI invocations, but a steady caller (MCP daemon, HTTP
    front-end, load generator) paying a connect + server-side accept +
    thread spawn per request burns the single host core on churn at
    high rates.  The server's handler already speaks one-JSON-line-per-
    request over a long-lived connection; this client keeps one socket
    open and streams requests down it (reconnecting once on a dropped
    socket).  Not thread-safe — use one instance per caller thread.
    """

    def __init__(
        self, data_dir: str, timeout: float = REQUEST_TIMEOUT_S
    ) -> None:
        self._path = str(socket_path_for(data_dir))
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._rfile = None

    def _connect(self) -> None:
        self.close()
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self._timeout)
        sock.connect(self._path)
        self._sock = sock
        self._rfile = sock.makefile("rb")

    def request(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Send one request; raises OSError if the server is unreachable.

        A DROPPED connection (daemon restart) reconnects and re-sends
        once — the old process is gone, so the first copy died with it.
        A TIMEOUT never re-sends: the server is alive and may still be
        processing (e.g. a search queued behind a minutes-long reindex
        on the worker thread); re-sending would execute the request
        twice and desynchronize this connection's response stream."""
        data = (json.dumps(payload) + "\n").encode("utf-8")
        for attempt in (0, 1):
            if self._sock is None:
                self._connect()
            try:
                self._sock.sendall(data)
                line = self._rfile.readline()
                if line:
                    return json.loads(line.decode("utf-8"))
                # Server closed the connection; reconnect once.
                self._sock = None
            except socket.timeout:
                self.close()
                raise OSError(
                    f"query server did not respond within "
                    f"{self._timeout:.0f}s (request not retried: the "
                    f"server may still be processing it)"
                )
            except OSError:
                self._sock = None
                if attempt:
                    raise
        raise OSError("query server closed the connection")

    def search(
        self, query: str, top_k: int = 10, **kwargs: object
    ) -> Dict[str, Any]:
        return self.request(
            {"op": "search", "query": query, "top_k": top_k, **kwargs}
        )

    def close(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "QueryClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def request(
    data_dir: str,
    payload: Dict[str, Any],
    timeout: float = REQUEST_TIMEOUT_S,
) -> Optional[Dict[str, Any]]:
    """Send one request to the warm server; None if it isn't reachable."""
    path = socket_path_for(data_dir)
    if not path.exists():
        return None
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.settimeout(timeout)
            sock.connect(str(path))
            sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
            buf = b""
            while not buf.endswith(b"\n"):
                piece = sock.recv(65536)
                if not piece:
                    break
                buf += piece
        if not buf:
            return None
        return json.loads(buf.decode("utf-8"))
    except (OSError, json.JSONDecodeError) as exc:
        logger.debug("Query server unreachable: %s", exc)
        return None
