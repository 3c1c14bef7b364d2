"""The port's MCP stdio server (``tpu_search_torch/interfaces/
mcp_server.py``, a verbatim copy of the JAX package's): the cases of
``tests/test_mcp_server.py`` pointed at the port's modules (tool schemas,
JSON-RPC handling, markdown output, truncation, error codes), and the
golden transcript of ``tests/test_mcp_conformance.py`` replayed against
the port's server process over a corpus indexed by the port's CLI
(``hash-768``, ``CLAUDE_SEARCH_DEVICE=cpu``, a bootstrap that imports no
jax): every server frame equal in canonical JSON.  Then the tools the
transcript does not call, on the same corpus, against the JAX package's
``call_tool``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_http_server import _port_cases

REPO = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).parent / "fixtures" / "mcp_golden_transcript.jsonl"


globals().update(_port_cases("test_mcp_server"))

_BOOTSTRAP = (
    "import sys; sys.modules['jax'] = None; "  # importing jax would fail
    "from tpu_search_torch.interfaces.mcp_server import main; main()"
)


def _transcript():
    client, server = [], []
    for line in FIXTURE.read_text().splitlines():
        rec = json.loads(line)
        if "_comment" not in rec:
            (client if rec["dir"] == "client" else server).append(
                rec["frame"])
    return client, server


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The conformance corpus (``tests/test_mcp_conformance.py``'s bytes),
    indexed by the port's CLI; returns the environment that points at it."""
    tmp_path = tmp_path_factory.mktemp("mcp_port")
    proj = tmp_path / "projects" / "demo-project"
    proj.mkdir(parents=True)
    lines = []
    for i in range(4):
        text = (
            "how do I profile jax programs on tpu hardware "
            if i % 2 == 0
            else "use jax.profiler.trace and perfetto to inspect xla ops "
        ) * 10
        lines.append(json.dumps({
            "uuid": f"u{i}", "sessionId": "sess-1",
            "timestamp": f"2025-06-01T10:0{i}:00Z",
            "message": {"role": "user" if i % 2 == 0 else "assistant",
                        "content": [{"type": "text", "text": text}]},
        }))
    (proj / "sess-1.jsonl").write_text("\n".join(lines) + "\n")
    env = dict(os.environ, CLAUDE_SEARCH_DATA_DIR=str(tmp_path / "data"),
               CLAUDE_SEARCH_MODEL="hash-768", CLAUDE_SEARCH_DEVICE="cpu")
    subprocess.run(
        [sys.executable, "-m", "tpu_search_torch.interfaces.cli", "index",
         "--claude-dir", str(tmp_path / "projects")],
        env=env, cwd=str(REPO), capture_output=True, check=True, timeout=300)
    return env


def _serve(env, frames):
    proc = subprocess.run(
        [sys.executable, "-c", _BOOTSTRAP],
        input="".join(json.dumps(f) + "\n" for f in frames),
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-800:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.strip()]


def _canon(frame) -> str:
    return json.dumps(frame, sort_keys=True)


def test_golden_transcript_frame_for_frame(corpus):
    client, golden = _transcript()
    live = _serve(corpus, client)
    assert len(live) == len(golden)
    for i, (want, got) in enumerate(zip(golden, live)):
        assert _canon(got) == _canon(want), (
            f"frame {i} (id={want.get('id')}):\nwant: {_canon(want)[:400]}"
            f"\n got: {_canon(got)[:400]}")


@pytest.mark.parametrize("name,arguments", [
    ("claude_semantic_search", {"query": "perfetto xla", "top_k": 3}),
    ("claude_semantic_search", {"query": "jax", "project": "demo"}),
    ("claude_semantic_search", {"chunk_id": "chunk_000001"}),
    ("claude_semantic_search", {"related_to": "chunk_000001",
                                "same_session": True}),
    ("claude_semantic_search", {"query": "profile",
                                "related_to": "chunk_000002"}),
    ("get_chunk_by_id", {"chunk_id": "chunk_000002"}),
])
def test_tools_equal_the_jax_server(corpus, monkeypatch, name, arguments):
    """Each tool call through the port's server process gives the JAX
    package's ``call_tool`` text on the same data directory."""
    from tpu_search.interfaces import mcp_server as jax_mcp

    for key in ("CLAUDE_SEARCH_DATA_DIR", "CLAUDE_SEARCH_MODEL"):
        monkeypatch.setenv(key, corpus[key])
    monkeypatch.setattr(jax_mcp, "search_cli", None)
    frames = [{"jsonrpc": "2.0", "id": 1, "method": "tools/call",
               "params": {"name": name, "arguments": arguments}}]
    (got,) = _serve(corpus, frames)
    engine = jax_mcp.get_search_cli()
    engine.use_warm_server = False
    engine.storage.config.device = "cpu"
    want = jax_mcp.call_tool(name, arguments)
    assert got["result"]["content"] == want
