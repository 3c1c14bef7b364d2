"""Index factory: build or load the right index kind.

Counterpart of ``tpu_search/index/registry.py``; ``load_index`` peeks the
``kind`` in a TPUSIDX2 header.
"""

from __future__ import annotations

from typing import Optional

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


def load_index(  # noqa: ann - returns any index engine (union)
    path: str, device: Optional[torch.device] = None
):
    from .serialize import is_streamed_file, read_file

    if not is_streamed_file(path):
        raise NotImplementedError(
            f"{path} is not a TPUSIDX2 file; the round-1 npz format is not "
            f"ported")
    kind = read_file(path)[0].get("kind", "flat")
    if kind == "flat":
        return FlatIndex.load(path, device=device)
    if kind == "ivf":
        return IVFIndex.load(path, device=device)
    raise ValueError(f"Unknown index kind in {path}: {kind}")
