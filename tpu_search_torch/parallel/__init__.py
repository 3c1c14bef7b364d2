"""Several devices and processes: the mesh, the process group and the
sharded indexes.

Counterpart of ``tpu_search/parallel``.  Ported: ``build_mesh``, the
``torch.distributed`` layer, ``ShardedFlatIndex`` and ``ShardedIVFIndex``
(with its refine tier, ``sharded_refine``).  Not yet ported
(``tests/test_torch_exports.py`` gives each name its reason):
data-parallel encode and the training step.
"""

from .distributed import (
    initialize_distributed,
    is_distributed,
    process_count,
    process_index,
)
from .mesh import Mesh, build_mesh
from .sharded_index import ShardedFlatIndex
from .sharded_ivf import ShardedIVFIndex

__all__ = [
    "Mesh",
    "ShardedFlatIndex",
    "ShardedIVFIndex",
    "build_mesh",
    "initialize_distributed",
    "is_distributed",
    "process_count",
    "process_index",
]
