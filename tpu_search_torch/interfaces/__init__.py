"""User-facing interfaces: the argparse CLI, the warm query server, the
watcher daemon and its file watching."""

__all__ = ["cli", "query_server", "watcher", "fswatch"]
