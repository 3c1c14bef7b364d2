"""User-facing interfaces: the argparse CLI, the MCP stdio server, the
warm query server and its HTTP front, the watcher daemon and its file
watching."""

__all__ = ["cli", "mcp_server", "query_server", "http_server", "watcher",
           "fswatch"]
