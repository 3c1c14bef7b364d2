"""The port's watcher (``tpu_search_torch/interfaces/watcher.py``) and its
verbatim fswatch copy: the cases of ``tests/test_watcher.py`` pointed at
the port (debounce, event filtering, PID-file lifecycle, a live
inotify/polling round), the spawn case as "start the daemon after torch
has initialized in the parent", ``http_port`` refused, and the daemon
indexing a new file and answering searches through its warm server on
the CPU.  Every wait has a deadline."""

import os
import time
from unittest.mock import MagicMock, patch

import pytest

from tpu_search_torch.interfaces.fswatch import (
    FileEvent,
    InotifyWatch,
    PollingWatch,
    create_watch,
)
from tpu_search_torch.interfaces.watcher import (
    ConversationFileHandler,
    ConversationWatcher,
)


@pytest.fixture
def engine():
    mock = MagicMock()
    mock.index_conversations.return_value = {
        "files_processed": 1,
        "files_unchanged": 0,
        "files_skipped": 0,
        "chunks_indexed": 5,
        "chunks_removed": 0,
        "errors": [],
        "duration": 0.01,
    }
    return mock


class TestHandler:
    def test_non_jsonl_ignored(self, engine):
        handler = ConversationFileHandler(engine, debounce_seconds=1)
        handler.on_event(FileEvent("/tmp/x/notes.txt", "modified"))
        assert handler.pending_files == set()

    def test_jsonl_scheduled(self, engine):
        handler = ConversationFileHandler(engine, debounce_seconds=30)
        handler.on_event(FileEvent("/tmp/x/conv.jsonl", "created"))
        assert "/tmp/x/conv.jsonl" in handler.pending_files
        assert handler.timer is not None and handler.timer.is_alive()
        handler.timer.cancel()

    def test_debounce_resets_timer(self, engine):
        handler = ConversationFileHandler(engine, debounce_seconds=30)
        handler.on_event(FileEvent("/tmp/a.jsonl", "created"))
        first = handler.timer
        handler.on_event(FileEvent("/tmp/b.jsonl", "created"))
        assert handler.timer is not first
        # cancel() marks the timer finished but the thread only exits when
        # next scheduled — join so a loaded core can't flake the assert.
        first.join(timeout=10)
        assert not first.is_alive()
        handler.timer.cancel()

    def test_trigger_indexes_per_directory(self, engine, tmp_path):
        d = tmp_path / "proj"
        d.mkdir()
        (d / "a.jsonl").write_text("{}")
        (d / "b.jsonl").write_text("{}")
        handler = ConversationFileHandler(engine, debounce_seconds=1)
        handler.pending_files = {str(d / "a.jsonl")}
        handler._trigger_indexing()
        engine.index_conversations.assert_called_once()
        files_arg = engine.index_conversations.call_args[0][0]
        assert sorted(p.name for p in files_arg) == ["a.jsonl", "b.jsonl"]
        assert handler.pending_files == set()
        assert handler.last_trigger_time is not None

    def test_trigger_with_nothing_pending(self, engine):
        handler = ConversationFileHandler(engine, debounce_seconds=1)
        handler._trigger_indexing()
        engine.index_conversations.assert_not_called()

    def test_indexing_errors_swallowed(self, engine, tmp_path):
        engine.index_conversations.side_effect = RuntimeError("index died")
        d = tmp_path / "p"
        d.mkdir()
        (d / "x.jsonl").write_text("{}")
        handler = ConversationFileHandler(engine, debounce_seconds=1)
        handler.pending_files = {str(d / "x.jsonl")}
        handler._trigger_indexing()  # must not raise


class TestDaemonLifecycle:
    def _watcher(self, tmp_path):
        with patch("tpu_search_torch.interfaces.watcher.SearchEngine"):
            return ConversationWatcher(data_dir=str(tmp_path))

    def test_pid_file_roundtrip(self, tmp_path):
        watcher = self._watcher(tmp_path)
        watcher.write_pid_file()
        assert watcher.pid_file.exists()
        assert watcher.get_daemon_pid() == os.getpid()
        assert watcher.is_daemon_running() is True
        watcher.remove_pid_file()
        assert not watcher.pid_file.exists()
        assert watcher.is_daemon_running() is False

    def test_stale_pid_cleanup(self, tmp_path):
        watcher = self._watcher(tmp_path)
        watcher.pid_file.parent.mkdir(parents=True, exist_ok=True)
        watcher.pid_file.write_text("999999999")  # no such process
        assert watcher.is_daemon_running() is False
        assert not watcher.pid_file.exists()

    def test_corrupt_pid_cleanup(self, tmp_path):
        watcher = self._watcher(tmp_path)
        watcher.pid_file.parent.mkdir(parents=True, exist_ok=True)
        watcher.pid_file.write_text("not-a-pid")
        assert watcher.is_daemon_running() is False

    def test_stop_daemon_not_running(self, tmp_path):
        watcher = self._watcher(tmp_path)
        with pytest.raises(RuntimeError, match="not running"):
            watcher.stop_daemon()

    def test_missing_claude_dir_raises(self, tmp_path):
        watcher = self._watcher(tmp_path)
        with pytest.raises(FileNotFoundError):
            watcher.start_watching(str(tmp_path / "nope"))

    def test_get_status_shape(self, tmp_path):
        watcher = self._watcher(tmp_path)
        status = watcher.get_status()
        assert status["is_running"] is False
        assert status["pending_files"] == 0
        assert status["debounce_seconds"] == 5


class TestDaemonSpawn:
    """The daemon must come up via spawn (fresh interpreter), never via
    fork from a parent that has initialized torch (a CUDA context does not
    survive fork)."""

    def test_start_daemon_after_torch_init_in_parent(
        self, tmp_path, monkeypatch, capsys
    ):
        import warnings

        import torch

        from tpu_search_torch.interfaces import watcher as W

        torch.ones(4).sum()  # the parent's torch runtime is initialized
        claude = tmp_path / "projects"
        claude.mkdir()
        data = tmp_path / "data"
        monkeypatch.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
        monkeypatch.setenv("CLAUDE_SEARCH_DATA_DIR", str(data))

        # The parent must never construct an engine: it only spawns and
        # verifies the PID file.
        with patch(
            "tpu_search_torch.interfaces.watcher.SearchEngine",
            side_effect=AssertionError("engine built in parent"),
        ), warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            W.start_daemon(str(data), str(claude), debounce_seconds=1,
                           device="cpu")
        out = capsys.readouterr().out
        assert "started with PID" in out
        pid = int((data / "watcher.pid").read_text())
        assert pid != os.getpid()
        try:
            os.kill(pid, 0)  # alive
        finally:
            W.stop_daemon(str(data))
        assert not (data / "watcher.pid").exists()

    def test_start_daemon_twice_fails_fast(self, tmp_path, capsys):
        from tpu_search_torch.interfaces import watcher as W

        data = tmp_path / "data"
        data.mkdir()
        (data / "watcher.pid").write_text(str(os.getpid()))
        with pytest.raises(SystemExit):
            W.start_daemon(str(data), str(tmp_path))
        assert "already running" in capsys.readouterr().out


class TestPortOnly:
    def test_http_port_refused(self, tmp_path, capsys):
        from tpu_search_torch.interfaces import cli
        from tpu_search_torch.interfaces import watcher as W

        with pytest.raises(NotImplementedError, match="HTTP"):
            ConversationWatcher(data_dir=str(tmp_path), http_port=8765)
        with pytest.raises(NotImplementedError, match="HTTP"):
            W.start_daemon(str(tmp_path), str(tmp_path), http_port=8765)
        with pytest.raises(NotImplementedError, match="HTTP"):
            W.run_watcher(str(tmp_path), str(tmp_path), http_port=8765)
        with pytest.raises(NotImplementedError, match="HTTP"):
            cli.main(["--data-dir", str(tmp_path), "start",
                      "--claude-dir", str(tmp_path), "--http-port", "8765"])
        assert not (tmp_path / "watcher.pid").exists()

    def test_daemon_indexes_and_serves_warm_searches(
        self, tmp_path, monkeypatch, capsys
    ):
        """``cli start`` on the CPU: a new conversation file is indexed by
        the daemon, a client engine finds it through the warm server (the
        server's ``stats`` op answers from the daemon's engine), ``stop``
        ends it and ``status`` reports it stopped."""
        import json

        from tpu_search_torch.api.engine import SearchEngine
        from tpu_search_torch.interfaces import cli
        from tpu_search_torch.interfaces.query_server import (
            request,
            socket_path_for,
        )

        claude = tmp_path / "projects" / "-root-proj"
        claude.mkdir(parents=True)
        data = tmp_path / "data"
        monkeypatch.setenv("CLAUDE_SEARCH_MODEL", "hash-768")
        cli.main(["--data-dir", str(data), "--device", "cpu", "start",
                  "--claude-dir", str(tmp_path / "projects"),
                  "--debounce", "1"])
        assert "started with PID" in capsys.readouterr().out
        pid = int((data / "watcher.pid").read_text())
        try:
            deadline = time.time() + 60
            while not socket_path_for(str(data)).exists():
                assert time.time() < deadline, "no query socket"
                time.sleep(0.1)
            text = "the daemon indexes this conversation about zeppelins " * 3
            (claude / "s9.jsonl").write_text("".join(
                json.dumps({
                    "uuid": f"u{i}", "sessionId": "s9",
                    "timestamp": f"2025-07-01T09:0{i}:00Z",
                    "message": {"role": role, "content": [
                        {"type": "text", "text": text}]},
                }) + "\n"
                for i, role in enumerate(("user", "assistant"))))
            client = SearchEngine(str(data), device="cpu")
            deadline = time.time() + 60
            while True:
                results = client.search_conversations("zeppelins", top_k=3)
                if results:
                    break
                assert time.time() < deadline, "the new file never indexed"
                time.sleep(0.2)
            assert results[0]["session"] == "s9"
            stats = request(str(data), {"op": "stats"}, timeout=30)
            assert stats["ok"] and stats["stats"]["total_chunks"] >= 1
            assert request(str(data), {"op": "ping"}, timeout=30)[
                "pid"] == pid
            assert not client.embedder.is_model_loaded  # served warm
            client._warm_clients.client.close()
        finally:
            cli.main(["--data-dir", str(data), "stop"])
        capsys.readouterr()
        cli.main(["--data-dir", str(data), "status"])
        assert "not running" in capsys.readouterr().out


class TestFsWatchBackends:
    def test_polling_detects_create_and_modify(self, tmp_path):
        events = []
        watch = PollingWatch(
            str(tmp_path), events.append, interval=0.1
        )
        watch.start()
        try:
            time.sleep(0.15)
            target = tmp_path / "conv.jsonl"
            target.write_text("{}")
            time.sleep(0.3)
            os.utime(target, (time.time() + 5, time.time() + 5))
            time.sleep(0.3)
        finally:
            watch.stop()
        kinds = [e.kind for e in events if e.path.endswith("conv.jsonl")]
        assert "created" in kinds
        assert "modified" in kinds

    @pytest.mark.skipif(os.name != "posix", reason="inotify is Linux-only")
    def test_inotify_detects_events(self, tmp_path):
        events = []
        try:
            watch = InotifyWatch(str(tmp_path), events.append)
            watch.start()
        except OSError:
            pytest.skip("inotify unavailable")
        try:
            sub = tmp_path / "newdir"
            sub.mkdir()
            time.sleep(0.3)
            (sub / "conv.jsonl").write_text("{}")
            deadline = time.time() + 3
            while time.time() < deadline and not any(
                e.path.endswith("conv.jsonl") for e in events
            ):
                time.sleep(0.1)
        finally:
            watch.stop()
        assert any(e.path.endswith("conv.jsonl") for e in events)

    def test_create_watch_returns_backend(self, tmp_path):
        watch = create_watch(str(tmp_path), lambda e: None)
        assert isinstance(watch, (InotifyWatch, PollingWatch))
