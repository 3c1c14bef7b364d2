"""MCP stdio server: the five search tools over newline-delimited JSON-RPC.

Tool-surface parity with the reference server (reference:
src/mcp_server.py:26-347): ``claude_semantic_search``, ``get_chunk_by_id``,
``list_projects``, ``get_stats``, ``get_status`` with identical input schemas
and markdown-formatted results (500-char truncation unless ``full_content``).

The reference depends on the ``mcp`` SDK; this implementation speaks the MCP
stdio protocol (JSON-RPC 2.0, ``initialize`` / ``tools/list`` / ``tools/call``)
directly, so the server has zero extra dependencies.  A module-global engine
keeps the model and index warm across tool calls (reference:
src/mcp_server.py:132-140).
"""

from __future__ import annotations

import json
import logging
import sqlite3
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..api.engine import SearchEngine, resolve_data_dir

logger = logging.getLogger(__name__)

__all__ = [
    "McpError",
    "SERVER_NAME",
    "PROTOCOL_VERSION",
    "list_tools",
    "call_tool",
    "get_search_cli",
    "handle_message",
    "main",
    "run",
]

SERVER_NAME = "claude-search"
SERVER_VERSION = "0.1.0"
PROTOCOL_VERSION = "2024-11-05"

METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603


class McpError(Exception):
    """JSON-RPC error with an MCP error code."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code
        self.message = message


search_cli: Optional[SearchEngine] = None


def get_search_cli(use_gpu: bool = False) -> SearchEngine:
    """Cached engine keyed on the accelerator flag; model/index stay warm."""
    global search_cli
    if search_cli is None or search_cli.use_gpu != use_gpu:
        search_cli = SearchEngine(resolve_data_dir(None), use_gpu=use_gpu)
    return search_cli


# ---------------------------------------------------------------------------
# Tool definitions (schemas identical to reference: src/mcp_server.py:26-129)
# ---------------------------------------------------------------------------


def list_tools() -> List[Dict[str, Any]]:
    return [
        {
            "name": "claude_semantic_search",
            "description": "Search Claude conversations using semantic similarity",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "query": {
                        "type": "string",
                        "description": "Search query text",
                    },
                    "top_k": {
                        "type": "integer",
                        "description": "Number of results (default: 20)",
                        "default": 20,
                    },
                    "project": {
                        "type": "string",
                        "description": "Filter by project name (supports partial matching)",
                    },
                    "has_code": {
                        "type": "boolean",
                        "description": "Only show results with code",
                    },
                    "after": {
                        "type": "string",
                        "description": "Filter after date (YYYY-MM-DD)",
                    },
                    "before": {
                        "type": "string",
                        "description": "Filter before date (YYYY-MM-DD)",
                    },
                    "session": {
                        "type": "string",
                        "description": "Filter by session ID",
                    },
                    "related_to": {
                        "type": "string",
                        "description": "Find chunks related to given chunk ID",
                    },
                    "same_session": {
                        "type": "boolean",
                        "description": "Include chunks from same session as related_to",
                    },
                    "full_content": {
                        "type": "boolean",
                        "description": "Show full content instead of truncated",
                        "default": False,
                    },
                    "use_gpu": {
                        "type": "boolean",
                        "description": "Use TPU acceleration for faster search",
                        "default": False,
                    },
                    "chunk_id": {
                        "type": "string",
                        "description": "Get specific chunk by ID (ignores query and other filters)",
                    },
                },
                "required": [],
            },
        },
        {
            "name": "get_chunk_by_id",
            "description": "Get a specific conversation chunk by its ID",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "chunk_id": {
                        "type": "string",
                        "description": "The chunk ID",
                    }
                },
                "required": ["chunk_id"],
            },
        },
        {
            "name": "list_projects",
            "description": "List all indexed Claude projects",
            "inputSchema": {"type": "object", "properties": {}},
        },
        {
            "name": "get_stats",
            "description": "Get search index statistics",
            "inputSchema": {"type": "object", "properties": {}},
        },
        {
            "name": "get_status",
            "description": "Get the status of the indexing daemon and last index update",
            "inputSchema": {"type": "object", "properties": {}},
        },
    ]


# ---------------------------------------------------------------------------
# Tool implementations
# ---------------------------------------------------------------------------


def _text(text: str) -> Dict[str, Any]:
    return {"type": "text", "text": text}


def _chunk_card(cli: SearchEngine, chunk_id: str) -> List[Dict[str, Any]]:
    chunk = cli.storage.get_chunk_by_id(chunk_id)
    if not chunk:
        raise McpError(INVALID_PARAMS, f"Chunk not found: {chunk_id}")
    data = cli.storage._get_chunk_data(chunk_id) or {}
    return [
        _text(
            f"**Chunk ID**: {chunk_id}\n"
            f"**Project**: {data.get('project_name', 'Unknown')}\n"
            f"**Time**: {data.get('timestamp', 'Unknown')}\n\n"
            f"{chunk.text}"
        )
    ]


def _semantic_search(arguments: Dict[str, Any]) -> List[Dict[str, Any]]:
    chunk_id = arguments.get("chunk_id")
    if chunk_id:
        cli = get_search_cli()
        cli.storage.initialize_metadata()  # no vector index needed
        return _chunk_card(cli, chunk_id)

    query: str = arguments.get("query", "")
    top_k: int = arguments.get("top_k", 20)
    use_gpu: bool = arguments.get("use_gpu", False)

    filters: Dict[str, Any] = {}
    if arguments.get("project"):
        filters["project_name"] = arguments["project"]
    if arguments.get("has_code"):
        filters["has_code"] = True
    if arguments.get("after") or arguments.get("before"):
        timestamp_filter: Dict[str, str] = {}
        if arguments.get("after"):
            timestamp_filter["gte"] = f"{arguments['after']}T00:00:00+00:00"
        if arguments.get("before"):
            timestamp_filter["lte"] = f"{arguments['before']}T23:59:59+00:00"
        filters["timestamp"] = timestamp_filter
    if arguments.get("session"):
        filters["session_id"] = arguments["session"]

    cli = get_search_cli(use_gpu)

    # related_to: resolve the reference chunk's session and filter on it
    # (improves on the reference, which forwarded a meaningless filter key:
    # src/mcp_server.py:195-198 vs the CLI's handling at src/cli.py:453).
    if arguments.get("related_to"):
        cli.storage.initialize_metadata()  # session lookup needs SQL only
        ref = cli.storage._get_chunk_data(arguments["related_to"])
        if not ref:
            raise McpError(
                INVALID_PARAMS,
                f"Reference chunk not found: {arguments['related_to']}",
            )
        session_id = ref.get("session_id")
        if not session_id:
            raise McpError(
                INVALID_PARAMS,
                f"Reference chunk has no session ID: "
                f"{arguments['related_to']}",
            )
        filters["session_id"] = session_id
        if arguments.get("same_session"):
            chunks = cli.storage.get_chunks_by_session(session_id)
            results = [
                {
                    "chunk_id": c.id,
                    "similarity": 1.0,
                    "text": c.text,
                    "project": (c.metadata or {}).get("project_name", "unknown"),
                    "session": session_id,
                    "timestamp": (c.metadata or {}).get("timestamp", "unknown"),
                    "has_code": (c.metadata or {}).get("has_code", False),
                }
                for c in chunks
                if c.id != arguments["related_to"]
            ]
            results.sort(key=lambda r: str(r["timestamp"]))
            return _format_results(
                query or f"session {session_id}",
                results[:top_k],
                arguments.get("full_content", False),
            )

    results = cli.search_conversations(query, filters, top_k)
    return _format_results(
        query, results, arguments.get("full_content", False)
    )


def _format_results(
    query: str, results: List[Dict[str, Any]], full_content: bool
) -> List[Dict[str, Any]]:
    blocks: List[str] = []
    for i, result in enumerate(results, 1):
        content = result["text"] or ""
        if not full_content and len(content) > 500:
            content = content[:500] + "..."
        similarity = (
            float(result["similarity"])
            if result.get("similarity") is not None
            else 0.0
        )
        blocks.append(
            f"### Result {i} [Similarity: {similarity:.3f}]\n"
            f"**Chunk ID**: {result['chunk_id']}\n"
            f"**Project**: {result.get('project', 'Unknown')}\n"
            f"**Time**: {result.get('timestamp', 'Unknown')}\n"
            f"**Session**: {result.get('session', 'Unknown')}\n\n"
            f"{content}\n"
            f"{'🔧 Contains code' if result.get('has_code') else ''}\n"
            f"---\n"
        )
    return [
        _text(
            f"Found {len(results)} results for: '{query}'\n\n"
            + "\n".join(blocks)
        )
    ]


def _get_stats() -> List[Dict[str, Any]]:
    cli = get_search_cli()
    stats = cli.get_index_stats()
    chunk_types = "\n".join(
        f"- {k}: {v:,}" for k, v in stats.get("chunk_types", {}).items()
    )
    return [
        _text(
            "**Search Index Statistics**\n\n"
            f"- Total chunks: {stats['total_chunks']:,}\n"
            f"- Total sessions: {stats['total_sessions']:,}\n"
            f"- Total projects: {stats['total_projects']:,}\n"
            f"- Index size: "
            f"{stats.get('faiss_index_size', 0) / 1024 / 1024:.1f} MB\n"
            f"- Database size: "
            f"{stats.get('database_size', 0) / 1024 / 1024:.1f} MB\n"
            f"- Total storage: "
            f"{stats.get('total_storage_size', 0) / 1024 / 1024:.1f} MB\n\n"
            f"**Chunk Types**:\n{chunk_types}"
        )
    ]


def _get_status() -> List[Dict[str, Any]]:
    from .watcher import ConversationWatcher

    cli = get_search_cli()
    # Reuse the watcher's PID-liveness logic (incl. stale-PID cleanup).
    is_running = ConversationWatcher(
        data_dir=str(cli.data_dir)
    ).is_daemon_running()

    last_indexed = "Never"
    try:
        cli.storage.initialize_metadata()
        value = cli.storage.meta.last_indexed()
        if value:
            last_indexed = value
    except Exception:
        pass
    return [
        _text(
            "**Indexing Status**\n\n"
            f"- Daemon running: {'✅ Yes' if is_running else '❌ No'}\n"
            f"- Last index update: {last_indexed}\n"
            f"- Index location: {cli.data_dir}/\n"
        )
    ]


def call_tool(name: str, arguments: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Dispatch one tool call; returns MCP content blocks."""
    if name == "claude_semantic_search":
        return _semantic_search(arguments)
    if name == "get_chunk_by_id":
        cli = get_search_cli()
        cli.storage.initialize_metadata()
        return _chunk_card(cli, arguments.get("chunk_id"))
    if name == "list_projects":
        cli = get_search_cli()
        try:
            cli.storage.initialize_metadata()
            projects = cli.storage.get_all_projects()
            listing = (
                "\n".join(f"- {p}" for p in projects)
                if projects
                else "*No projects found in the index*"
            )
            return [
                _text(
                    f"**Indexed Projects ({len(projects)})**:\n\n{listing}"
                )
            ]
        except McpError:
            raise
        except Exception as exc:
            raise McpError(
                INTERNAL_ERROR, f"Failed to retrieve projects: {exc}"
            )
    if name == "get_stats":
        return _get_stats()
    if name == "get_status":
        return _get_status()
    raise McpError(METHOD_NOT_FOUND, f"Unknown tool: {name}")


# ---------------------------------------------------------------------------
# JSON-RPC stdio transport
# ---------------------------------------------------------------------------


def handle_message(message: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Process one JSON-RPC message; returns the response (None for
    notifications)."""
    method = message.get("method")
    msg_id = message.get("id")
    params = message.get("params") or {}

    def ok(result: Dict[str, Any]) -> Dict[str, Any]:
        return {"jsonrpc": "2.0", "id": msg_id, "result": result}

    def err(code: int, text: str) -> Dict[str, Any]:
        return {
            "jsonrpc": "2.0",
            "id": msg_id,
            "error": {"code": code, "message": text},
        }

    if method == "initialize":
        return ok(
            {
                "protocolVersion": params.get(
                    "protocolVersion", PROTOCOL_VERSION
                ),
                "capabilities": {"tools": {}},
                "serverInfo": {
                    "name": SERVER_NAME,
                    "version": SERVER_VERSION,
                },
            }
        )
    if method in ("notifications/initialized", "initialized"):
        return None
    if method == "ping":
        return ok({})
    if method == "tools/list":
        return ok({"tools": list_tools()})
    if method == "tools/call":
        try:
            content = call_tool(
                params.get("name", ""), params.get("arguments") or {}
            )
            return ok({"content": content, "isError": False})
        except McpError as exc:
            return err(exc.code, exc.message)
        except Exception as exc:
            logger.exception("Tool call failed")
            return err(INTERNAL_ERROR, str(exc))
    if msg_id is None:
        return None  # unknown notification: ignore
    return err(METHOD_NOT_FOUND, f"Method not found: {method}")


def main() -> None:
    """Blocking stdio serve loop (newline-delimited JSON-RPC)."""
    stdin = sys.stdin
    stdout = sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            message = json.loads(line)
        except json.JSONDecodeError:
            continue
        response = handle_message(message)
        if response is not None:
            stdout.write(json.dumps(response) + "\n")
            stdout.flush()


def run() -> None:
    """Entry point for the claude-search-mcp console script."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()


if __name__ == "__main__":
    run()
