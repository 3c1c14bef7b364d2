"""Index factory: build or load the right index kind.

Counterpart of ``tpu_search/index/registry.py``; ``load_index`` peeks the
``kind`` in a TPUSIDX2 header or in a round-1 npz file's.
"""

from __future__ import annotations

import json
import zipfile
from typing import Optional

import numpy as np
import torch

from .flat import FlatIndex
from .ivf import IVFIndex

__all__ = ["create_index", "load_index"]


def create_index(  # noqa: ann - returns any index engine (union)
    kind: str,
    dim: int,
    metric: str = "ip",
    dtype: str = "bfloat16",
    device: Optional[torch.device] = None,
    nlist: int = 100,
    opq: bool = False,
    refine_dtype: str = "none",
    refine_factor: int = 4,
    pq_auto: bool = False,
    pq_target_recall: float = 0.9,
):
    if kind == "flat":
        return FlatIndex(dim=dim, metric=metric, dtype=dtype, device=device)
    if kind == "ivf":
        return IVFIndex(
            dim=dim, metric=metric, dtype=dtype, device=device, nlist=nlist,
            opq=opq, refine_dtype=refine_dtype, refine_factor=refine_factor,
            pq_auto=pq_auto, pq_target_recall=pq_target_recall,
        )
    raise ValueError(f"Unknown index type: {kind}")


def _peek_kind(path: str) -> str:
    from .serialize import is_streamed_file, read_file

    if is_streamed_file(path):
        header, _ = read_file(path)
        return header.get("kind", "flat")
    # The round-1 npz format.
    with zipfile.ZipFile(path) as zf:
        with zf.open("header.npy") as fh:
            header = json.loads(str(np.load(fh)))
    return header.get("kind", "flat")


def load_index(  # noqa: ann - returns any index engine (union)
    path: str, device: Optional[torch.device] = None
):
    kind = _peek_kind(path)
    if kind == "flat":
        return FlatIndex.load(path, device=device)
    if kind == "ivf":
        return IVFIndex.load(path, device=device)
    raise ValueError(f"Unknown index kind in {path}: {kind}")
