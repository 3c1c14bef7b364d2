"""Several devices and processes: the mesh, the process group and the
sharded exact index.

Counterpart of ``tpu_search/parallel``.  Ported: ``build_mesh``, the
``torch.distributed`` layer and ``ShardedFlatIndex``.  Not yet ported
(``tests/test_torch_exports.py`` gives each name its reason): the sharded
IVF index, data-parallel encode and the training step.
"""

from .distributed import (
    initialize_distributed,
    is_distributed,
    process_count,
    process_index,
)
from .mesh import Mesh, build_mesh
from .sharded_index import ShardedFlatIndex

__all__ = [
    "Mesh",
    "ShardedFlatIndex",
    "build_mesh",
    "initialize_distributed",
    "is_distributed",
    "process_count",
    "process_index",
]
