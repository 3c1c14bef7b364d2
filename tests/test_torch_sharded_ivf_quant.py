"""``test_torch_sharded_ivf.py``'s lifecycle parity with the JAX
``ShardedIVFIndex`` on the quantized cases: int8, int4, pq, pq with OPQ,
int4 with the int8 refine tier and int8 with the bf16 one (a file of its
own, so that a parallel test run gives them a worker of their own)."""

import pytest

from test_torch_sharded_ivf import (  # noqa: F401  (_env, meshes: fixtures)
    CASES,
    FLOAT_CASES,
    _env,
    make_pair,
    meshes,
    test_lifecycle_matches_jax,
)


@pytest.fixture(scope="module",
                params=sorted(set(CASES) - set(FLOAT_CASES)))
def pair(request, meshes):
    return make_pair(request.param, meshes)
