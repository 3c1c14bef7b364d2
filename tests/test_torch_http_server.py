"""The port's HTTP front (``tpu_search_torch/interfaces/http_server.py``, a
verbatim copy of the JAX package's): the cases of
``tests/test_http_server.py`` pointed at the port's modules (routes, filter
mapping, error handling, worker sharing, the watcher's HTTP face), and
``cli serve`` end to end on the CPU with the hashing encoder, its answers
held against the JAX ``SearchEngine`` on the same data directory.

Every socket carries a timeout and every wait a deadline.
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from test_torch_host_copies import write_transcripts
from tpu_search_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def _port_cases(name: str) -> dict:
    """The test module ``tests/<name>.py`` with every ``tpu_search.``
    reference pointed at ``tpu_search_torch.``: its fixtures, helpers and
    test classes, to collect here."""
    source = (Path(__file__).parent / f"{name}.py").read_text()
    source = source.replace("tpu_search.", "tpu_search_torch.")
    namespace = {"__name__": __name__, "__file__": __file__}
    exec(compile(source, f"{name}.py on tpu_search_torch", "exec"), namespace)
    return {k: v for k, v in namespace.items() if not k.startswith("__")}


globals().update(_port_cases("test_http_server"))

QUERIES = ["tok1 tok2 tok3", "tok40 tok41", "tok7 tok13 tok19 tok23",
           "python code tok5", "tok58"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A data directory indexed by the port's CLI (``hash-768``) and the
    port's ``serve --port 0`` on it; yields ``(data_dir, port)``."""
    root = tmp_path_factory.mktemp("serve")
    write_transcripts(root)
    data = root / "data"
    env = dict(os.environ, CLAUDE_SEARCH_MODEL="hash-768",
               CLAUDE_SEARCH_DEVICE="cpu")
    cli = [sys.executable, "-m", "tpu_search_torch.interfaces.cli",
           "--data-dir", str(data), "--device", "cpu"]
    subprocess.run([*cli, "index", "--claude-dir",
                    str(root / "claude-projects")], env=env, cwd=str(REPO),
                   capture_output=True, check=True, timeout=300)
    proc = subprocess.Popen([*cli, "serve", "--port", "0"], env=env,
                            cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        deadline = time.time() + 120
        port = None
        while port is None:
            assert time.time() < deadline, "serve printed no banner"
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "serve exited"
            match = re.search(r"Search API on http://127\.0\.0\.1:(\d+)", line)
            port = int(match.group(1)) if match else None
        yield data, port
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_a_server_process_writes_its_launch_counts(tmp_path):
    """``CLAUDE_SEARCH_LAUNCH_LOG``: a process that imported the kernel
    registry writes its launch counts there at exit."""
    log = tmp_path / "launches.json"
    subprocess.run([sys.executable, "-c",
                    "from tpu_search_torch.ops import _build; "
                    "_build.LAUNCHES['flat_topk'] += 2"],
                   env=dict(os.environ, CLAUDE_SEARCH_LAUNCH_LOG=str(log)),
                   cwd=str(REPO), check=True, timeout=120)
    counts = json.loads(log.read_text())
    assert counts == {name: 2 if name == "flat_topk" else 0
                      for name in _build.KERNELS}


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_serve_answers_as_the_jax_engine(served, monkeypatch):
    """``/v1/search`` through ``serve`` returns the JAX engine's results on
    the same directory: ids equal, similarities within 1e-6."""
    from urllib.parse import quote

    from tpu_search.api.engine import SearchEngine as JaxSearchEngine

    data, port = served
    monkeypatch.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
    ref = JaxSearchEngine(str(data), use_warm_server=False)
    ref.storage.config.device = "cpu"
    for query in QUERIES:
        got = _get(port, f"/v1/search?q={quote(query)}&top_k=5")
        assert got["ok"], got
        want = ref.search_conversations(query, top_k=5)
        assert [r["chunk_id"] for r in got["results"]] == [
            r["chunk_id"] for r in want]
        for a, b in zip(got["results"], want):
            assert abs(a["similarity"] - b["similarity"]) <= 1e-6


def test_serve_routes(served):
    """``/healthz``, ``/v1/stats``, ``/v1/projects``, ``/v1/chunks/<id>``
    and a ``project`` filter on the served directory."""
    _, port = served
    assert _get(port, "/healthz")["model_loaded"] is True
    stats = _get(port, "/v1/stats")["stats"]
    assert stats["total_chunks"] > 0 and stats["total_projects"] == 2
    assert sorted(_get(port, "/v1/projects")["projects"]) == [
        "-root-myproj", "-root-other"]
    chunk = _get(port, "/v1/chunks/chunk_000001")["chunk"]
    assert chunk["id"] == "chunk_000001" and chunk["text"]
    hits = _get(port, "/v1/search?q=tok1&top_k=10&project=other")["results"]
    assert hits and {r["project"] for r in hits} == {"-root-other"}
