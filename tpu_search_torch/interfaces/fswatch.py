"""Filesystem watching without third-party dependencies.

The reference uses the ``watchdog`` package (reference: src/watcher.py:20-21,
:170).  This module provides the same capability natively: a Linux inotify
backend through ctypes (recursive watches, create/modify events) with a
portable mtime-polling fallback for other platforms.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import logging
import os
import struct
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Set

logger = logging.getLogger(__name__)

__all__ = ["FileEvent", "Watch", "InotifyWatch", "PollingWatch", "create_watch"]

# inotify event masks (linux/inotify.h)
IN_CREATE = 0x00000100
IN_MODIFY = 0x00000002
IN_MOVED_TO = 0x00000080
IN_CLOSE_WRITE = 0x00000008
IN_ISDIR = 0x40000000
IN_NONBLOCK = 0o4000

_EVENT_STRUCT = struct.Struct("iIII")  # wd, mask, cookie, len


class FileEvent:
    """A created/modified file event."""

    __slots__ = ("path", "kind")

    def __init__(self, path: str, kind: str) -> None:
        self.path = path
        self.kind = kind  # "created" | "modified"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FileEvent({self.kind}: {self.path})"


class Watch:
    """Base interface: watch a tree, invoke callback(FileEvent) per change."""

    def __init__(
        self, root: str, callback: Callable[[FileEvent], None]
    ) -> None:
        self.root = str(Path(root))
        self.callback = callback
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class InotifyWatch(Watch):
    """Recursive inotify watcher (Linux) via raw syscalls through libc."""

    def __init__(
        self, root: str, callback: Callable[[FileEvent], None]
    ) -> None:
        super().__init__(root, callback)
        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self._fd: Optional[int] = None
        self._wd_to_dir: Dict[int, str] = {}

    def probe(self) -> None:
        """Verify inotify actually initializes (fd/watch limits) so
        create_watch can fall back to polling BEFORE start()."""
        fd = self._libc.inotify_init1(IN_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        os.close(fd)

    def _add_watch(self, directory: str) -> None:
        mask = IN_CREATE | IN_MODIFY | IN_MOVED_TO | IN_CLOSE_WRITE
        wd = self._libc.inotify_add_watch(
            self._fd, os.fsencode(directory), mask
        )
        if wd >= 0:
            self._wd_to_dir[wd] = directory

    def _watch_tree(self, root: str) -> None:
        self._add_watch(root)
        for dirpath, dirnames, _ in os.walk(root):
            for name in dirnames:
                self._add_watch(os.path.join(dirpath, name))

    def start(self) -> None:
        fd = self._libc.inotify_init1(IN_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        self._watch_tree(self.root)
        super().start()

    def stop(self) -> None:
        super().stop()
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _loop(self) -> None:
        while self._running:
            try:
                data = os.read(self._fd, 65536)
            except BlockingIOError:
                time.sleep(0.2)
                continue
            except OSError as exc:  # fd closed during stop()
                if exc.errno in (errno.EBADF, errno.EINVAL):
                    return
                raise
            offset = 0
            while offset + _EVENT_STRUCT.size <= len(data):
                wd, mask, _cookie, name_len = _EVENT_STRUCT.unpack_from(
                    data, offset
                )
                offset += _EVENT_STRUCT.size
                name = data[offset : offset + name_len].split(b"\0", 1)[0]
                offset += name_len
                directory = self._wd_to_dir.get(wd)
                if directory is None or not name:
                    continue
                path = os.path.join(directory, os.fsdecode(name))
                if mask & IN_ISDIR:
                    if mask & (IN_CREATE | IN_MOVED_TO):
                        self._watch_tree(path)  # new subdir: start watching
                    continue
                if mask & (IN_CREATE | IN_MOVED_TO):
                    self.callback(FileEvent(path, "created"))
                elif mask & (IN_MODIFY | IN_CLOSE_WRITE):
                    self.callback(FileEvent(path, "modified"))


class PollingWatch(Watch):
    """Portable fallback: scan mtimes every ``interval`` seconds."""

    def __init__(
        self,
        root: str,
        callback: Callable[[FileEvent], None],
        interval: float = 2.0,
        pattern: str = "*.jsonl",
    ) -> None:
        super().__init__(root, callback)
        self.interval = interval
        self.pattern = pattern
        self._snapshot: Dict[str, float] = {}

    def _scan(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        root = Path(self.root)
        if not root.exists():
            return out
        for path in root.rglob(self.pattern):
            try:
                out[str(path)] = path.stat().st_mtime
            except OSError:
                continue
        return out

    def start(self) -> None:
        self._snapshot = self._scan()
        super().start()

    def _loop(self) -> None:
        while self._running:
            time.sleep(self.interval)
            current = self._scan()
            for path, mtime in current.items():
                if path not in self._snapshot:
                    self.callback(FileEvent(path, "created"))
                elif mtime > self._snapshot[path]:
                    self.callback(FileEvent(path, "modified"))
            self._snapshot = current


def create_watch(
    root: str, callback: Callable[[FileEvent], None]
) -> Watch:
    """Prefer inotify on Linux; fall back to polling elsewhere."""
    if os.name == "posix" and Path("/proc").exists():
        try:
            watch = InotifyWatch(root, callback)
            watch.probe()  # surface fd/watch-limit failures here
            return watch
        except OSError:
            pass
    return PollingWatch(root, callback)
