"""The rest of the port's CLI (``tpu_search_torch/interfaces/cli.py``)
against the JAX package's click CLI on one data directory: ``search
--chunk-id``, ``--related-to`` and ``--related-to --same-session`` with
``--json`` print the same JSON, the semantic ``--related-to`` search the
same ids (similarities within 1e-6); ``--gpu`` is accepted by every
command that has it; ``index --trace DIR`` writes a ``torch.profiler``
trace; each ``*_command`` runs its subcommand.
"""

import json
import sys

import pytest

from test_torch_host_copies import write_transcripts
from tpu_search_torch.interfaces import cli as port_cli

COMMANDS = ("index", "search", "stats", "watch", "start", "stop", "status",
            "serve", "optimize")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_surface")
    write_transcripts(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
        port_cli.main(["--data-dir", str(root / "data"), "--device", "cpu",
                       "index", "--claude-dir",
                       str(root / "claude-projects")])
    return root / "data"


def _port(capsys, data_dir, *args) -> str:
    capsys.readouterr()
    port_cli.main(["--data-dir", str(data_dir), "--device", "cpu", *args])
    return capsys.readouterr().out


def _jax(data_dir, *args) -> str:
    from click.testing import CliRunner

    from tpu_search.interfaces.cli import cli

    result = CliRunner().invoke(cli, ["--data-dir", str(data_dir), *args])
    assert result.exit_code == 0, result.output
    return result.stdout


@pytest.mark.parametrize("args", [
    ("search", "x", "--chunk-id", "chunk_000002", "--json"),
    ("search", "x", "--chunk-id", "chunk_000007", "--json"),
    ("search", "x", "--related-to", "chunk_000002", "--same-session",
     "--json"),
    ("search", "x", "--related-to", "chunk_000009", "--same-session",
     "--top-k", "1", "--json"),
    ("search", "x", "--chunk-id", "chunk_000003"),
    ("search", "x", "--related-to", "chunk_000003", "--same-session",
     "--full-content"),
])
def test_sql_only_output_equals_jax(capsys, monkeypatch, data_dir, args):
    monkeypatch.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
    port = _port(capsys, data_dir, *args)
    assert port == _jax(data_dir, *args)
    if "--json" in args:
        assert json.loads(port)["items"]


def test_same_session_lists_the_session_in_time_order(capsys, data_dir):
    items = json.loads(_port(capsys, data_dir, "search", "--related-to",
                             "chunk_000001", "--same-session", "--json",
                             "--top-k", "100"))["items"]
    session = {item["variables"]["session"] for item in items}
    stamps = [item["variables"]["timestamp"] for item in items]
    assert len(session) == 1 and stamps == sorted(stamps)
    assert "chunk_000001" not in [item["uid"] for item in items]


def test_related_to_semantic_search_equals_jax(capsys, monkeypatch, data_dir):
    monkeypatch.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
    args = ("search", "tok3 tok4 tok5", "--related-to", "chunk_000002",
            "--json")
    port = json.loads(_port(capsys, data_dir, *args))["items"]
    ref = json.loads(_jax(data_dir, *args))["items"]
    assert [i["uid"] for i in port] == [i["uid"] for i in ref]
    assert len({i["variables"]["session"] for i in port}) == 1
    for a, b in zip(port, ref):
        assert abs(a["variables"]["similarity"]
                   - b["variables"]["similarity"]) <= 1e-6


def test_missing_chunk_exits_1(capsys, data_dir):
    with pytest.raises(SystemExit) as info:
        _port(capsys, data_dir, "search", "--chunk-id", "no-such-chunk")
    assert info.value.code == 1
    assert "Chunk not found" in capsys.readouterr().out


@pytest.mark.parametrize("command", [
    ["index"], ["search", "q"], ["stats"], ["watch"], ["start"],
    ["serve"], ["optimize"],
])
def test_gpu_flag_accepted(command):
    args = port_cli.build_parser().parse_args([*command, "--gpu"])
    assert args.gpu is True


def test_stats_gpu_prints_the_device_block(capsys, data_dir):
    out = _port(capsys, data_dir, "stats", "--gpu")
    assert "Total chunks" in out and "CUDA devices" in out


def test_index_trace_writes_a_trace(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
    write_transcripts(tmp_path)
    trace = tmp_path / "trace"
    _port(capsys, tmp_path / "data", "index", "--claude-dir",
          str(tmp_path / "claude-projects"), "--trace", str(trace))
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert events


@pytest.mark.parametrize("name", COMMANDS)
def test_command_shims_run_their_subcommand(monkeypatch, name):
    calls = []
    monkeypatch.setattr(port_cli, "main", calls.append)
    monkeypatch.setattr(sys, "argv", ["anything", "--flag", "value"])
    getattr(port_cli, f"{name}_command")()
    assert calls == [[name, "--flag", "value"]]
    assert sys.argv[0] == f"claude-{name}"


def test_stats_command_end_to_end(capsys, monkeypatch, data_dir):
    monkeypatch.setattr(sys, "argv", ["claude-stats"])
    monkeypatch.setenv("CLAUDE_SEARCH_DATA_DIR", str(data_dir))
    monkeypatch.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
    capsys.readouterr()
    port_cli.stats_command()
    assert "Total chunks" in capsys.readouterr().out
