"""Several devices and processes: the mesh and its sharding rules, the
process group, the sharded indexes, data- and tensor-parallel encode and
the training step.

Counterpart of ``tpu_search/parallel``: every name of its ``__all__``,
and the port's own ``Mesh``, ``NamedSharding`` and
``train_state_from_numpy`` (a JAX train state carried into the port's).
The multi-chip dry run is ``parallel/dryrun.py``.
"""

from .distributed import (
    initialize_distributed,
    is_distributed,
    process_count,
    process_index,
)
from .encode import make_sharded_encode, shard_params
from .mesh import (
    Mesh,
    NamedSharding,
    build_mesh,
    data_sharding,
    encoder_param_specs,
    replicated,
)
from .sharded_index import ShardedFlatIndex
from .sharded_ivf import ShardedIVFIndex
from .train import (
    TrainState,
    infonce_loss,
    init_train_state,
    load_train_state,
    make_train_step,
    save_train_state,
    train_state_from_numpy,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "ShardedFlatIndex",
    "ShardedIVFIndex",
    "TrainState",
    "build_mesh",
    "data_sharding",
    "encoder_param_specs",
    "infonce_loss",
    "init_train_state",
    "initialize_distributed",
    "is_distributed",
    "load_train_state",
    "make_sharded_encode",
    "make_train_step",
    "process_count",
    "process_index",
    "replicated",
    "save_train_state",
    "shard_params",
    "train_state_from_numpy",
]
