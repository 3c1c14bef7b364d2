"""Core orchestration API shared by all interfaces."""

from .engine import (
    DEFAULT_DATA_DIR,
    SearchEngine,
    SemanticSearchCLI,
    resolve_data_dir,
)

__all__ = [
    "DEFAULT_DATA_DIR",
    "SearchEngine",
    "SemanticSearchCLI",
    "resolve_data_dir",
]
