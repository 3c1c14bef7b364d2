"""Inputs of the IVF digit scans' prologue, shared by the CPU test
(``test_torch_ivf_prep.py``, against the JAX package) and the card test
(``test_torch_cuda.py``, the kernel against its plain twin).  numpy only:
the card's machine has no jax.

Each case: ``(probe [Q, nprobe] int32, fills [nlist] int32, queries [Q, D]
f32, cbias [Q, nprobe] f32 or None, cap)``.  No query probes a cluster
twice; clusters repeat across queries.
"""

import numpy as np

# name: (nlist, cap, d, q, nprobe, residual)
CASES = {
    "nlist9_q1": (9, 256, 64, 1, 3, False),
    "nlist9_q8": (9, 256, 64, 8, 4, True),
    "nlist9_q33_all_probed": (9, 256, 64, 33, 9, True),
    "nlist1024_q33": (1024, 512, 128, 33, 32, True),
    "nlist1024_q128": (1024, 512, 128, 128, 8, False),
    "nlist4099_q1": (4099, 256, 32, 1, 64, True),
    "nlist4099_q128_all_probed": (4099, 256, 32, 128, 4099, True),
    "empty_schedule": (9, 256, 64, 8, 2, True),
}


def make_case(name: str):
    nlist, cap, d, q, nprobe, residual = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    fills = rng.integers(0, cap + 1, size=nlist).astype(np.int32)
    fills[1::7] = 0  # empty clusters
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(q)])
    probe = probe.astype(np.int32)
    if name == "empty_schedule":
        fills[:] = 0
    elif nprobe < nlist:
        probe[:, 0] = 1  # every query probes an empty cluster
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[0, : d // 2] *= 40.0  # one query of uneven magnitudes
    if q > 2:
        queries[2] = 0.0  # the 1e-12 floor of both scales
    cbias = (rng.standard_normal((q, nprobe)).astype(np.float32)
             if residual else None)
    return probe, fills, queries, cbias, cap
