"""Command line for the port: ``index``, ``search``, ``stats``,
``optimize``, ``serve`` and the watcher daemon's ``watch``, ``start``,
``stop`` and ``status``.

Same commands, flags and output as the JAX package's CLI
(``tpu_search/interfaces/cli.py``), on ``argparse``::

    python -m tpu_search_torch.interfaces.cli --data-dir D index --claude-dir P
    python -m tpu_search_torch.interfaces.cli --data-dir D search "query" --json
    python -m tpu_search_torch.interfaces.cli --data-dir D search --chunk-id ID
    python -m tpu_search_torch.interfaces.cli --data-dir D search \
        --related-to ID --same-session --json
    python -m tpu_search_torch.interfaces.cli --data-dir D stats --gpu
    python -m tpu_search_torch.interfaces.cli --data-dir D optimize
    python -m tpu_search_torch.interfaces.cli --data-dir D serve --port 8765
    python -m tpu_search_torch.interfaces.cli --data-dir D start \
        --claude-dir P --http-port 8766
    python -m tpu_search_torch.interfaces.cli --data-dir D status
    python -m tpu_search_torch.interfaces.cli --data-dir D stop

``--device`` (or ``CLAUDE_SEARCH_DEVICE``) picks ``cuda`` (default) or
``cpu``, for the daemon too.  While a daemon runs on the data directory, ``search``
and ``stats`` go through its warm query server.  ``--chunk-id`` and
``--related-to`` read SQLite alone (no model or index loads).  ``serve``
warms the model and index, runs one search (which captures the fused
query graph on the card) and serves the HTTP search API
(``interfaces/http_server.py``); ``--http-port`` attaches the same API to
the daemon.  ``index --trace DIR`` writes a ``torch.profiler`` trace of
the run into ``DIR``.  ``search --rerank`` reorders the top ``top_k *
--rerank-factor`` with the cross-encoder ``--rerank-model`` (defaults:
``CLAUDE_SEARCH_RERANK``, ``_RERANK_FACTOR``, ``_RERANK_MODEL``).  The
``*_command`` functions run one command each, as console scripts.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from datetime import datetime
from typing import Any, Dict, List, Optional

from ..api.engine import SearchEngine, resolve_data_dir

logger = logging.getLogger(__name__)


def _alfred_items(results: List[Dict[str, Any]], subtitle_fn,
                  include_similarity: bool = True) -> str:
    """Alfred/launcher JSON (the JAX CLI's ``--json`` shape); a direct
    chunk retrieval has no similarity."""

    def variables(r):
        out = {"similarity": r["similarity"]} if include_similarity else {}
        out.update(project=r["project"], session=r["session"],
                   timestamp=r["timestamp"])
        return out

    return json.dumps(
        {
            "items": [
                {
                    "uid": r["chunk_id"],
                    "title": (
                        r["text"][:100] + "..."
                        if len(r["text"]) > 100
                        else r["text"]
                    ),
                    "subtitle": subtitle_fn(r),
                    "arg": r["chunk_id"],
                    "text": r["text"],
                    "quicklookurl": "",
                    "variables": variables(r),
                }
                for r in results
            ]
        },
        indent=2,
    )


def _print_results(results, full_content: bool,
                   related_to: Optional[str] = None) -> None:
    for i, r in enumerate(results, 1):
        if related_to:
            print(f"{i}. [Related] {r['project']}")
        elif "rerank_score" in r:
            print(f"{i}. [Rerank: {r['rerank_score']:.3f} | "
                  f"Similarity: {r['similarity']:.3f}] {r['project']}")
        else:
            print(f"{i}. [Similarity: {r['similarity']:.3f}] {r['project']}")
        if full_content:
            print(f"   {r['text']}")
        else:
            print(f"   {r['text'][:200]}...")
        print(f"   Session: {r['session']} | Time: {r['timestamp']}")
        if r["has_code"]:
            print("   🔧 Contains code")
        print()


def _filters(args) -> Dict[str, Any]:
    filters: Dict[str, Any] = {}
    if args.project:
        filters["project_name"] = args.project
    if args.has_code:
        filters["has_code"] = True
    if args.session:
        filters["session_id"] = args.session
    if args.after or args.before:
        ts: Dict[str, str] = {}
        for flag, value, clock, key in (
            ("--after", args.after, "T00:00:00+00:00", "gte"),
            ("--before", args.before, "T23:59:59+00:00", "lte"),
        ):
            if not value:
                continue
            try:
                ts[key] = datetime.fromisoformat(f"{value}{clock}").isoformat()
            except ValueError:
                print(f"❌ Invalid date format for {flag}: {value}. "
                      f"Use YYYY-MM-DD format.")
                sys.exit(1)
        filters["timestamp"] = ts
    return filters


def cmd_index(engine: SearchEngine, args) -> None:
    from ..utils.profiling import device_trace

    files = engine.scan_claude_projects(args.claude_dir)
    print("🚀 Starting conversation indexing...")
    if args.force:
        print("🗑️  Force flag detected - clearing all existing data...")
    with device_trace(args.trace):
        stats = engine.index_conversations(files, args.force)
    print("\n🎉 Indexing complete!")
    print("📊 Statistics:")
    print(f"   • Files processed: {stats['files_processed']}")
    print(f"   • Files unchanged: {stats.get('files_unchanged', 0)}")
    print(f"   • Files skipped: {stats['files_skipped']}")
    print(f"   • Chunks created: {stats['chunks_created']}")
    print(f"   • Chunks indexed: {stats['chunks_indexed']}")
    if stats.get("chunks_removed", 0) > 0:
        print(f"   • Chunks removed: {stats['chunks_removed']}")
    print(f"   • Duration: {stats['duration']:.1f}s")
    if stats.get("phases"):
        print("   • Phase breakdown:")
        for name, info in stats["phases"].items():
            print(f"     - {name}: {info['seconds']:.2f}s "
                  f"({info['fraction'] * 100:.0f}%)")
    if stats["errors"]:
        print(f"   • Errors: {len(stats['errors'])}")
        for error in stats["errors"][:3]:
            print(f"     - {error}")


def _record(chunk_id: str, text: str, meta: Dict[str, Any],
            similarity: Optional[float] = None) -> Dict[str, Any]:
    record = {
        "chunk_id": chunk_id,
        "text": text,
        "project": meta.get("project_name", "unknown"),
        "session": meta.get("session_id", "unknown"),
        "timestamp": meta.get("timestamp", "unknown"),
        "has_code": meta.get("has_code", False),
    }
    if similarity is not None:
        record["similarity"] = similarity
    return record


def _search_chunk_id(engine: SearchEngine, args) -> None:
    """Direct chunk retrieval: SQLite only, no model or index."""
    try:
        engine.storage.initialize_metadata()
        chunk = engine.storage.get_chunk_by_id(args.chunk_id)
        if not chunk:
            print(f"❌ Chunk not found: {args.chunk_id}")
            sys.exit(1)
        data = engine.storage._get_chunk_data(args.chunk_id) or {}
        record = _record(args.chunk_id, chunk.text, data)
    except SystemExit:
        raise
    except Exception as exc:
        print(f"❌ Failed to retrieve chunk: {exc}")
        sys.exit(1)
    if args.json:
        print(_alfred_items([record], lambda r: "Direct chunk retrieval",
                            include_similarity=False))
        return
    print(f"📄 Chunk: {args.chunk_id}")
    print(f"   Project: {record['project']}")
    print(f"   Session: {record['session']}")
    print(f"   Time: {record['timestamp']}")
    if record["has_code"]:
        print("   🔧 Contains code")
    print()
    print(chunk.text)


def _search_related(engine: SearchEngine, args) -> Optional[str]:
    """``--related-to``: with ``--same-session``, print the reference
    chunk's session (SQLite only) and return None; else return the
    session to filter the semantic search on."""
    related_to = args.related_to
    try:
        engine.storage.initialize_metadata()
        ref_data = engine.storage._get_chunk_data(related_to)
        if not ref_data:
            print(f"❌ Reference chunk not found: {related_to}")
            sys.exit(1)
        ref_session = ref_data.get("session_id")
        if not ref_session:
            print(f"❌ Reference chunk has no session ID: {related_to}")
            sys.exit(1)
        if not args.same_session:
            return ref_session
        results = [
            _record(chunk.id, chunk.text, chunk.metadata or {}, 1.0)
            for chunk in engine.storage.get_chunks_by_session(ref_session)
            if chunk.id != related_to
        ]
    except SystemExit:
        raise
    except Exception as exc:
        print(f"❌ Failed to find related chunks: {exc}")
        sys.exit(1)
    results.sort(key=lambda r: r["timestamp"])
    results = results[: args.top_k]
    if args.json:
        print(_alfred_items(
            results, lambda r: f"Related to {related_to} | Same session"))
    else:
        print(f"🔗 Found {len(results)} related chunks to {related_to} "
              f"(same session: {ref_session})")
        print()
        _print_results(results, args.full_content, related_to)
    return None


def cmd_search(engine: SearchEngine, args) -> None:
    if args.chunk_id:
        _search_chunk_id(engine, args)
        return
    if args.related_to:
        session = _search_related(engine, args)
        if session is None:
            return
        args.session = session
    filters = _filters(args)
    try:
        results = engine.search_conversations(
            args.query, filters, args.top_k, rerank=args.rerank,
            rerank_model=args.rerank_model, rerank_factor=args.rerank_factor,
        )
    except SystemExit:
        raise
    except Exception as exc:
        print(f"❌ Search failed: {exc}")
        sys.exit(1)
    if args.json:
        print(_alfred_items(
            results,
            lambda r: (f"Project: {r['project']} | "
                       f"Similarity: {r['similarity']:.3f}"),
        ))
    else:
        print(f"🔍 Found {len(results)} results for: '{args.query}'")
        print()
        _print_results(results, args.full_content)


def cmd_stats(engine: SearchEngine, args) -> None:
    try:
        info = engine.get_index_stats()
    except Exception as exc:
        print(f"❌ Failed to get stats: {exc}")
        sys.exit(1)
    mb = 1024 * 1024
    print("📊 Index Statistics:")
    print(f"   • Total chunks: {info['total_chunks']:,}")
    print(f"   • Total sessions: {info['total_sessions']:,}")
    print(f"   • Total projects: {info['total_projects']:,}")
    print(f"   • Index size: {info['faiss_index_size'] / mb:.1f} MB")
    print(f"   • Database size: {info['database_size'] / mb:.1f} MB")
    print(f"   • Total storage: {info['total_storage_size'] / mb:.1f} MB")
    print(f"   • Embedding dimension: {info['embedding_dimension']}")
    print(f"   • Index type: {info['index_type']}")
    device = info.get("device_info")
    if device:
        print(f"   • Device status: {device.get('status_message', 'Unknown')}")
    if args.gpu:
        _print_cuda_devices()
    if info["chunk_types"]:
        print("   • Chunk types:")
        for chunk_type, count in info["chunk_types"].items():
            print(f"     - {chunk_type}: {count:,}")


def _print_cuda_devices() -> None:
    """The ``stats --gpu`` device block, from ``torch.cuda``."""
    import torch

    if not torch.cuda.is_available():
        print("   • CUDA devices: none (torch.cuda.is_available() is false)")
        return
    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    free, total = torch.cuda.mem_get_info(0)
    print(f"   • Devices: {', '.join(names)}")
    print(f"   • Device memory: {free / 1024**3:.1f}GB free / "
          f"{total / 1024**3:.1f}GB total")


def cmd_serve(engine: SearchEngine, args) -> None:
    """Serve the search API over HTTP with a warm model and index, until
    Ctrl+C or SIGTERM."""
    import signal
    import time

    from .http_server import HttpFrontend

    def interrupt(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, interrupt)

    print("🔥 Warming model and index...", flush=True)
    try:
        engine.embedder.load_model()
        engine._sync_embedding_dim()
        engine.storage.initialize()
        # One search at the default k before the first client: it builds
        # (on the card, captures) the fused program of a one-query window.
        engine.search_conversations("server warmup query", top_k=10)
        frontend = HttpFrontend(engine=engine, host=args.host, port=args.port)
        frontend.start()
    except Exception as exc:
        print(f"❌ Failed to start server: {exc}")
        sys.exit(1)
    print(f"🌐 Search API on http://{frontend.host}:{frontend.port} "
          f"(Ctrl+C to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("\n👋 Server stopped")
    finally:
        frontend.stop()


def cmd_optimize(engine: SearchEngine, args) -> None:
    """Storage maintenance: vacuum, compact, rebalance, tune nprobe."""
    storage = engine.storage
    storage.initialize()
    if storage.index is None or not storage.index.ntotal:
        print("📭 Index is empty — nothing to optimize")
        return
    print("🔧 Optimizing storage...")
    before_live = storage.index.live
    before_total = storage.index.ntotal
    storage.optimize()
    print("✅ Optimization complete")
    print(f"   • Vectors: {before_total} → {storage.index.ntotal} "
          f"slots ({before_live} live)")
    hint = getattr(storage.index, "nprobe_hint", 0)
    if hint:
        print(f"   • IVF nprobe tuned to {hint} "
              f"(recall target {storage.config.ivf_autotune_recall})")
    if storage.config.auto_save:
        storage.save_index()
        print("   • Index saved")


def cmd_watch(args) -> None:
    """Watch for changes and index them: in the foreground, or with
    ``--daemon`` as the background daemon (``start``)."""
    if args.daemon:
        cmd_start(args)
        return
    from .watcher import run_watcher

    print("🔍 Starting file watcher...")
    print(f"   • Watching: {args.claude_dir}")
    print(f"   • Data directory: {resolve_data_dir(args.data_dir)}")
    print(f"   • Debounce interval: {args.debounce} seconds")
    if args.http_port is not None:
        print(f"   • HTTP search API: http://127.0.0.1:{args.http_port}")
    print("   • Press Ctrl+C to stop")
    print()
    try:
        run_watcher(data_dir=args.data_dir, claude_dir=args.claude_dir,
                    debounce_seconds=args.debounce, use_gpu=args.gpu,
                    http_port=args.http_port, device=args.device)
    except KeyboardInterrupt:
        print("\n👋 File watcher stopped")
    except Exception as exc:
        print(f"❌ Watcher failed: {exc}")
        sys.exit(1)


def cmd_start(args) -> None:
    """Start the watcher daemon (a fresh interpreter)."""
    from .watcher import start_daemon

    start_daemon(data_dir=args.data_dir, claude_dir=args.claude_dir,
                 debounce_seconds=args.debounce, use_gpu=args.gpu,
                 http_port=args.http_port, device=args.device)


def cmd_stop(args) -> None:
    from .watcher import stop_daemon

    stop_daemon(data_dir=args.data_dir)


def cmd_status(args) -> None:
    from .watcher import daemon_status

    daemon_status(data_dir=args.data_dir)


def _watch_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--claude-dir", default="~/.claude/projects",
                   help="Claude projects directory to watch")
    p.add_argument("--debounce", type=int, default=5,
                   help="Debounce interval in seconds (default: 5)")
    _gpu_flag(p)
    p.add_argument("--http-port", type=int, default=None,
                   help="Also serve the HTTP search API on this port")


def _gpu_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gpu", action="store_true",
                   help="Kept for the JAX CLI's flags (the device is "
                   "--device)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpu_search_torch",
        description="Claude Semantic Search (PyTorch/CUDA) — index and "
        "search your Claude conversations.",
    )
    parser.add_argument("--data-dir", default=None,
                        help="Data directory (env: CLAUDE_SEARCH_DATA_DIR)")
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="Compute device (env: CLAUDE_SEARCH_DEVICE; "
                        "default cuda)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="Index Claude conversations")
    p.add_argument("--claude-dir", default="~/.claude/projects",
                   help="Claude projects directory")
    p.add_argument("--force", action="store_true",
                   help="Force reindexing of all files")
    _gpu_flag(p)
    p.add_argument("--trace", default=None,
                   help="Write a torch.profiler trace of the run to this "
                   "directory (trace.json, Perfetto)")
    p.set_defaults(func=cmd_index)

    p = sub.add_parser("search", help="Search indexed conversations")
    p.add_argument("query", nargs="?", default="")
    p.add_argument("--top-k", type=int, default=10,
                   help="Number of results to return")
    p.add_argument("--project", help="Filter by project name (partial match)")
    p.add_argument("--has-code", action="store_true",
                   help="Filter for chunks with code")
    p.add_argument("--after", help="Filter for chunks after date (YYYY-MM-DD)")
    p.add_argument("--before", help="Filter for chunks before date (YYYY-MM-DD)")
    p.add_argument("--session", help="Filter by session ID")
    p.add_argument("--related-to",
                   help="Find chunks related to given chunk ID (same session)")
    p.add_argument("--same-session", action="store_true",
                   help="Include chunks from same session as --related-to")
    p.add_argument("--full-content", action="store_true",
                   help="Show full content instead of truncated")
    p.add_argument("--chunk-id", help="Get specific chunk by ID (ignores "
                   "query and other filters)")
    _gpu_flag(p)
    p.add_argument("--json", action="store_true",
                   help="Output results as JSON")
    p.add_argument("--rerank", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Re-order the top candidates with the cross-encoder "
                   "(default: CLAUDE_SEARCH_RERANK)")
    p.add_argument("--rerank-model",
                   help="Cross-encoder model (default: ms-marco-MiniLM-L-6-v2 "
                   "or $CLAUDE_SEARCH_RERANK_MODEL)")
    p.add_argument("--rerank-factor", type=int, default=None,
                   help="Stage-1 over-fetch multiple for reranking "
                   "(default 5, cap 100)")
    p.set_defaults(func=cmd_search)

    p = sub.add_parser("stats", help="Show index statistics")
    p.add_argument("--gpu", action="store_true",
                   help="Show the CUDA devices and their memory")
    p.set_defaults(func=cmd_stats)

    p = sub.add_parser("optimize", help="Run storage maintenance: vacuum, "
                       "compact, rebalance, tune nprobe")
    _gpu_flag(p)
    p.set_defaults(func=cmd_optimize, warm=False)

    p = sub.add_parser("serve", help="Serve the search API over HTTP with a "
                       "warm model and index")
    p.add_argument("--host", default="127.0.0.1", help="Bind address")
    p.add_argument("--port", type=int, default=8765,
                   help="Bind port (0 picks a free one)")
    _gpu_flag(p)
    p.set_defaults(func=cmd_serve, warm=False)

    # The daemon commands take no engine: the daemon builds its own.
    p = sub.add_parser("watch", help="Watch Claude conversations for "
                       "changes and auto-index them")
    _watch_flags(p)
    p.add_argument("--daemon", action="store_true",
                   help="Run as background daemon")
    p.set_defaults(func=cmd_watch, engine=False)
    p = sub.add_parser("start", help="Start the file watcher daemon")
    _watch_flags(p)
    p.set_defaults(func=cmd_start, engine=False)
    p = sub.add_parser("stop", help="Stop the file watcher daemon")
    p.set_defaults(func=cmd_stop, engine=False)
    p = sub.add_parser("status", help="Check the status of the file "
                       "watcher daemon")
    p.set_defaults(func=cmd_status, engine=False)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    args = build_parser().parse_args(argv)
    if not getattr(args, "engine", True):
        args.func(args)
        return
    engine = SearchEngine(resolve_data_dir(args.data_dir),
                          use_gpu=getattr(args, "gpu", False),
                          use_warm_server=getattr(args, "warm", True),
                          device=args.device)
    args.func(engine, args)


# -- console scripts (the JAX CLI's ``*_command`` shims) ----------------------


def _run_subcommand(name: str) -> None:
    sys.argv[0] = f"claude-{name}"
    main([name] + sys.argv[1:])


def index_command() -> None:
    _run_subcommand("index")


def search_command() -> None:
    _run_subcommand("search")


def stats_command() -> None:
    _run_subcommand("stats")


def watch_command() -> None:
    _run_subcommand("watch")


def start_command() -> None:
    _run_subcommand("start")


def stop_command() -> None:
    _run_subcommand("stop")


def status_command() -> None:
    _run_subcommand("status")


def serve_command() -> None:
    _run_subcommand("serve")


def optimize_command() -> None:
    _run_subcommand("optimize")


if __name__ == "__main__":
    main()
