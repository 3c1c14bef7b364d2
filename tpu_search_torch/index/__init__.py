"""Vector indexes."""

from .flat import FlatIndex
from .ivf import IVFIndex
from .registry import create_index, load_index

__all__ = ["FlatIndex", "IVFIndex", "create_index", "load_index"]
