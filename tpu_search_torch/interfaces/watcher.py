"""Auto-indexing daemon: watch ~/.claude/projects, debounce, reindex, and
serve warm searches.

The JAX package's watcher (``tpu_search/interfaces/watcher.py``) on the
port's engine: debounced incremental indexing grouped by parent directory,
the daemon spawned as a fresh interpreter, PID/log files in the data dir,
SIGTERM/SIGINT handling, stale-PID cleanup, model-load timeout, and status
with log tail.  The daemon hosts the warm query server
(``interfaces/query_server.py``) on its engine, so searches from the CLI
hit its warm model and index on the device, and with ``http_port`` the
HTTP front (``interfaces/http_server.py``) serves the same worker.  Uses
the native fswatch backend (inotify/polling) instead of the watchdog
package.

The engine runs on ``device`` (``cuda`` or ``cpu``; else
``CLAUDE_SEARCH_DEVICE``, else ``cuda``).  The watch starts before the
query socket binds, so no file written after the socket appears goes
unseen.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from datetime import datetime
from pathlib import Path
from typing import Optional, Set

from ..api.engine import SearchEngine, resolve_data_dir
from .fswatch import FileEvent, Watch, create_watch

logger = logging.getLogger(__name__)

__all__ = [
    "ConversationFileHandler",
    "ConversationWatcher",
    "run_watcher",
    "start_daemon",
    "stop_daemon",
    "daemon_status",
]


class ConversationFileHandler:
    """Debounces file events into incremental index runs
    (reference: src/watcher.py:28-116)."""

    def __init__(
        self, engine: SearchEngine, debounce_seconds: int = 5
    ) -> None:
        self.cli_instance = engine  # reference-compatible attribute name
        # When a warm query server runs in this process, indexing routes
        # through its worker thread so searches never race the reindex.
        self.executor = None  # Optional[Callable[[Callable], Any]]
        self.debounce_seconds = debounce_seconds
        self.pending_files: Set[str] = set()
        self.last_trigger_time: Optional[datetime] = None
        self.timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()

    # fswatch callback entrypoint
    def on_event(self, event: FileEvent) -> None:
        if not event.path.endswith(".jsonl"):
            return
        logger.info(
            "%s conversation file detected: %s",
            event.kind.capitalize(),
            event.path,
        )
        self._schedule_indexing(event.path)

    # reference-compatible shims
    def on_created(self, event: object) -> None:
        if not getattr(event, "is_directory", False):
            path = getattr(event, "src_path", getattr(event, "path", ""))
            if path.endswith(".jsonl"):
                self._schedule_indexing(path)

    on_modified = on_created

    def _schedule_indexing(self, file_path: str) -> None:
        with self._lock:
            self.pending_files.add(file_path)
            if self.timer is not None and self.timer.is_alive():
                self.timer.cancel()
            self.timer = threading.Timer(
                self.debounce_seconds, self._trigger_indexing
            )
            self.timer.start()

    def _trigger_indexing(self) -> None:
        with self._lock:
            if not self.pending_files:
                return
            files = list(self.pending_files)
            self.pending_files.clear()

        logger.info("Triggering incremental indexing for %d files", len(files))
        try:
            directories = {str(Path(f).parent) for f in files}
            for directory in directories:
                dir_files = sorted(Path(directory).glob("*.jsonl"))
                if not dir_files:
                    continue
                run = self.executor or (lambda fn: fn())
                stats = run(
                    lambda: self.cli_instance.index_conversations(
                        dir_files, force=False
                    )
                )
                logger.info(
                    "Incremental indexing complete: processed=%d unchanged=%d "
                    "skipped=%d chunks=%d removed=%d duration=%.1fs",
                    stats["files_processed"],
                    stats.get("files_unchanged", 0),
                    stats["files_skipped"],
                    stats["chunks_indexed"],
                    stats.get("chunks_removed", 0),
                    stats["duration"],
                )
                for error in stats["errors"][:3]:
                    logger.warning("  - %s", error)
            self.last_trigger_time = datetime.now()
        except Exception as exc:
            logger.error("Error during automatic indexing: %s", exc)


class ConversationWatcher:
    """Long-lived watcher process owning one warm SearchEngine
    (reference: src/watcher.py:119-333)."""

    def __init__(
        self,
        data_dir: Optional[str] = None,
        debounce_seconds: int = 5,
        use_gpu: bool = False,
        http_port: Optional[int] = None,
        device: Optional[str] = None,
    ) -> None:
        self.data_dir = resolve_data_dir(data_dir)
        self.debounce_seconds = debounce_seconds
        self.use_gpu = use_gpu
        self.http_port = http_port
        self.device = device
        # Engine construction is deferred to start_watching: the daemon
        # *control* paths (start/stop/status in the parent process) must
        # never load a model or touch CUDA — the daemon child is spawned
        # as a fresh interpreter precisely so no CUDA-initialized process
        # forks (reference forked eagerly, src/watcher.py:336-380).
        self.cli_instance: Optional[SearchEngine] = None
        self.handler: Optional[ConversationFileHandler] = None
        self.query_server = None  # started with watching; serves warm queries
        self.http_frontend = None  # optional HTTP face on the same worker
        self.watch: Optional[Watch] = None
        self.is_running = False
        self.pid_file = Path(self.data_dir) / "watcher.pid"
        self.log_file = Path(self.data_dir) / "watcher.log"

    def _ensure_engine(self) -> SearchEngine:
        """Build the warm engine on first use (CUDA init happens here,
        never in the parent that spawns the daemon)."""
        if self.cli_instance is None:
            self.cli_instance = SearchEngine(
                self.data_dir, self.use_gpu, use_warm_server=False,
                device=self.device,
            )
            self.handler = ConversationFileHandler(
                self.cli_instance, self.debounce_seconds
            )
        return self.cli_instance

    # -- foreground loop ----------------------------------------------------

    def start_watching(self, claude_dir: str = "~/.claude/projects") -> None:
        claude_path = Path(claude_dir).expanduser()
        if not claude_path.exists():
            raise FileNotFoundError(
                f"Claude projects directory not found: {claude_path}"
            )
        self._ensure_engine()
        logger.info("Starting file watcher for: %s", claude_path)
        logger.info("Debounce interval: %d seconds", self.debounce_seconds)

        # Watchdog on model/storage init (reference used 60s,
        # src/watcher.py:152; 180s here, as in the JAX package: a cold
        # CUDA context plus a large index load can take a minute).
        def timeout_handler(signum, frame):
            raise TimeoutError(
                "Model loading timeout (180s) - consider running "
                "'setup-models' first"
            )

        old_handler = signal.signal(signal.SIGALRM, timeout_handler)
        signal.alarm(180)
        try:
            if not self.cli_instance.embedder.is_model_loaded:
                logger.info("Loading embedding model...")
                self.cli_instance.embedder.load_model()
                logger.info("Model loaded successfully")
            # The model first: a fresh data dir's index takes the
            # encoder's width (MiniLM 384, mpnet 768), as indexing does.
            self.cli_instance._sync_embedding_dim()
            self.cli_instance.storage.initialize()
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old_handler)

        # The daemon doubles as the warm query server: CLI/MCP searches hit
        # this process's hot model+index instead of cold-starting.  The
        # watch starts before the socket binds, so a file written once the
        # socket is visible always raises an event; a debounced reindex
        # that fires before the worker exists waits for it.
        from .query_server import QueryServer

        self.query_server = QueryServer(self.cli_instance, self.data_dir)
        bound = threading.Event()

        def run_on_worker(fn):
            bound.wait()
            server = self.query_server
            worker = server._worker if server is not None else None
            return worker.run(fn) if worker is not None else fn()

        self.handler.executor = run_on_worker
        self.watch = create_watch(str(claude_path), self.handler.on_event)
        self.watch.start()
        try:
            self.query_server.start()
        except OSError as exc:
            logger.warning("Query server failed to start: %s", exc)
            self.query_server = None
        finally:
            bound.set()

        # Optional HTTP face on the SAME worker: searches over HTTP share
        # embed batches with socket clients and serialize against reindexing.
        if self.http_port is not None and self.query_server is not None:
            from .http_server import HttpFrontend

            try:
                self.http_frontend = HttpFrontend(
                    worker=self.query_server._worker, port=self.http_port
                )
                self.http_frontend.start()
            except OSError as exc:
                logger.warning("HTTP front-end failed to start: %s", exc)
                self.http_frontend = None

        self.is_running = True
        logger.info("File watcher started. Monitoring for changes...")
        try:
            while self.is_running:
                time.sleep(1)
        except KeyboardInterrupt:
            logger.info("Received interrupt signal, stopping watcher...")
        finally:
            self.stop_watching()

    def stop_watching(self) -> None:
        if self.http_frontend is not None:
            self.http_frontend.stop()
            self.http_frontend = None
        if self.query_server is not None:
            self.query_server.stop()
            self.query_server = None
        if self.watch is not None and self.watch.is_alive:
            self.watch.stop()
        if (
            self.handler is not None
            and self.handler.timer is not None
            and self.handler.timer.is_alive()
        ):
            self.handler.timer.cancel()
        self.is_running = False
        logger.info("File watcher stopped")

    def get_status(self) -> dict:
        return {
            "is_running": self.is_running,
            "watching_path": self.watch.root if self.watch else None,
            "pending_files": (
                len(self.handler.pending_files) if self.handler else 0
            ),
            "last_trigger_time": (
                self.handler.last_trigger_time.isoformat()
                if self.handler and self.handler.last_trigger_time
                else None
            ),
            "debounce_seconds": self.debounce_seconds,
        }

    # -- daemon plumbing ----------------------------------------------------

    def setup_daemon_logging(self) -> None:
        self.log_file.parent.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(str(self.log_file))
        handler.setLevel(logging.INFO)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
            )
        )
        root = logging.getLogger()
        root.addHandler(handler)
        root.setLevel(logging.INFO)

    def write_pid_file(self) -> None:
        self.pid_file.parent.mkdir(parents=True, exist_ok=True)
        self.pid_file.write_text(str(os.getpid()))
        logger.info("PID file written: %s", self.pid_file)

    def remove_pid_file(self) -> None:
        if self.pid_file.exists():
            self.pid_file.unlink()
            logger.info("PID file removed: %s", self.pid_file)

    def is_daemon_running(self) -> bool:
        if not self.pid_file.exists():
            return False
        try:
            pid = int(self.pid_file.read_text().strip())
            os.kill(pid, 0)
            return True
        except (OSError, ValueError):
            self.remove_pid_file()  # stale PID cleanup
            return False

    def get_daemon_pid(self) -> Optional[int]:
        if not self.pid_file.exists():
            return None
        try:
            return int(self.pid_file.read_text().strip())
        except (OSError, ValueError):
            return None

    def start_daemon(self, claude_dir: str = "~/.claude/projects") -> None:
        if self.is_daemon_running():
            raise RuntimeError("Watcher daemon is already running")

        def handle_signal(signum, frame):
            logger.info("Received signal %d, stopping daemon...", signum)
            self.stop_watching()
            self.remove_pid_file()
            sys.exit(0)

        signal.signal(signal.SIGTERM, handle_signal)
        signal.signal(signal.SIGINT, handle_signal)

        self.setup_daemon_logging()
        self.write_pid_file()
        logger.info("Starting watcher daemon...")
        logger.info("Watching directory: %s", claude_dir)
        logger.info("Data directory: %s", self.data_dir)
        try:
            self.start_watching(claude_dir)
        except Exception as exc:
            logger.error("Daemon failed: %s", exc)
            self.remove_pid_file()
            raise

    def stop_daemon(self) -> None:
        if not self.is_daemon_running():
            raise RuntimeError("Watcher daemon is not running")
        pid = self.get_daemon_pid()
        if pid:
            try:
                os.kill(pid, signal.SIGTERM)
                time.sleep(2)
                if self.is_daemon_running():
                    os.kill(pid, signal.SIGKILL)
                    time.sleep(1)
                logger.info("Daemon stopped (PID: %d)", pid)
            except OSError as exc:
                logger.error("Failed to stop daemon: %s", exc)
                raise
        self.remove_pid_file()


# -- module-level entry points (reference: src/watcher.py:336-435) -----------


def run_watcher(
    data_dir: Optional[str] = None,
    claude_dir: str = "~/.claude/projects",
    debounce_seconds: int = 5,
    use_gpu: bool = False,
    http_port: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    watcher = ConversationWatcher(
        resolve_data_dir(data_dir), debounce_seconds, use_gpu, http_port,
        device,
    )
    try:
        watcher.start_watching(claude_dir)
    except Exception as exc:
        logger.error("Failed to start watcher: %s", exc)
        raise


def start_daemon(
    data_dir: Optional[str] = None,
    claude_dir: str = "~/.claude/projects",
    debounce_seconds: int = 5,
    use_gpu: bool = False,
    http_port: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Launch the daemon as a freshly spawned interpreter.

    The reference fork()s from the caller (src/watcher.py:336-380); here the
    caller may already hold an initialized CUDA context (a prior search in
    the same process), and a process that has initialized CUDA must not
    fork: the child cannot use the context it inherits. Spawning
    re-executes Python, so the daemon always initializes CUDA in a clean
    process; stdio is detached at spawn so piped shells
    (`claude-start | tee log`) don't hang on inherited fds.
    """
    data_dir = resolve_data_dir(data_dir)
    watcher = ConversationWatcher(
        data_dir, debounce_seconds, use_gpu, http_port, device
    )
    if watcher.is_daemon_running():
        print("❌ Failed to start daemon: Watcher daemon is already running")
        sys.exit(1)

    cmd = [
        sys.executable,
        "-m",
        "tpu_search_torch.interfaces.watcher",
        "--daemon-child",
        "--data-dir",
        data_dir,
        "--claude-dir",
        claude_dir,
        "--debounce",
        str(debounce_seconds),
    ]
    if use_gpu:
        cmd.append("--gpu")
    if http_port is not None:
        cmd += ["--http-port", str(http_port)]
    if device is not None:
        cmd += ["--device", device]
    # The child must find this package even when running uninstalled from a
    # source checkout.
    env = dict(os.environ)
    pkg_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (
        pkg_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else pkg_root
    )
    try:
        child = subprocess.Popen(
            cmd,
            stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,
            env=env,
        )
    except OSError as exc:
        # No spawnable interpreter: run in the foreground as a last resort.
        logger.warning("Spawn failed (%s); running watcher in-process", exc)
        try:
            watcher.start_daemon(claude_dir)
        except Exception as inner:
            print(f"❌ Failed to start daemon: {inner}")
            sys.exit(1)
        return

    # Wait for the child to pass its startup checks (the PID file is written
    # after the already-running/daemonize validation) before claiming
    # success.
    def pid_file_is_child() -> bool:
        try:
            return int(watcher.pid_file.read_text().strip()) == child.pid
        except (OSError, ValueError):
            return False

    deadline = time.time() + 20
    child_exited = False
    while time.time() < deadline:
        if pid_file_is_child():
            break
        if child.poll() is not None:
            child_exited = True
            break
        time.sleep(0.2)
    if pid_file_is_child() and not child_exited:
        print(f"✅ Watcher daemon started with PID: {child.pid}")
        print(f"📁 Watching: {claude_dir}")
        print(f"💾 Data directory: {data_dir}")
        print(f"📝 Log file: {watcher.log_file}")
    else:
        print(f"❌ Watcher daemon failed to start (see {watcher.log_file})")
        sys.exit(1)


def stop_daemon(data_dir: Optional[str] = None) -> None:
    watcher = ConversationWatcher(resolve_data_dir(data_dir))
    try:
        watcher.stop_daemon()
        print("✅ Watcher daemon stopped")
    except RuntimeError as exc:
        print(f"❌ {exc}")
        sys.exit(1)
    except Exception as exc:
        print(f"❌ Failed to stop daemon: {exc}")
        sys.exit(1)


def daemon_status(data_dir: Optional[str] = None) -> bool:
    watcher = ConversationWatcher(resolve_data_dir(data_dir))
    if watcher.is_daemon_running():
        pid = watcher.get_daemon_pid()
        print(f"✅ Watcher daemon is running (PID: {pid})")
        print(f"📝 Log file: {watcher.log_file}")
        print(f"🔧 PID file: {watcher.pid_file}")
        if watcher.log_file.exists():
            print("\n📋 Recent log entries:")
            try:
                lines = watcher.log_file.read_text().splitlines()
                for line in lines[-5:]:
                    print(f"   {line}")
            except Exception:
                print("   (Could not read log file)")
    else:
        print("❌ Watcher daemon is not running")
        if watcher.log_file.exists():
            print(f"📝 Log file available: {watcher.log_file}")
    return watcher.is_daemon_running()


def _child_main(argv: Optional[list] = None) -> None:
    """Entry point of the spawned daemon process (``python -m
    tpu_search_torch.interfaces.watcher --daemon-child ...``)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="tpu_search_torch.interfaces.watcher"
    )
    parser.add_argument("--daemon-child", action="store_true")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--claude-dir", default="~/.claude/projects")
    parser.add_argument("--debounce", type=int, default=5)
    parser.add_argument("--gpu", action="store_true")
    parser.add_argument("--http-port", type=int, default=None)
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    watcher = ConversationWatcher(
        resolve_data_dir(args.data_dir),
        args.debounce,
        args.gpu,
        args.http_port,
        args.device,
    )
    if args.daemon_child:
        watcher.start_daemon(args.claude_dir)
    else:
        watcher.start_watching(args.claude_dir)


if __name__ == "__main__":
    _child_main()
