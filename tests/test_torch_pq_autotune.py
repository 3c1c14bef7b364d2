"""The port's PQ auto-config against ``tpu_search``'s on the CPU.

- ``tune_pq_config`` on the autotune corpora of ``tests/test_pq_autotune.py``
  (scaled down to at most 1,500 rows), with the same coarse centroids (the
  JAX package's k-means), chooses the same ``pq_m``, OPQ and refine factor;
  each plain-PQ recall of the trail is within 0.01 of the JAX one (the
  books train from the same numpy draws; a near-tie of the ADC ranking may
  swap a hit), the OPQ ones within 0.05 (the rotations themselves differ,
  see ``tests/test_torch_pq_codec.py``);
- ``deployed_quant_calibration`` on a JAX pq index carried into the port
  reports ``calibrated`` with the JAX report's operating point;
- the cases of ``tests/test_pq_autotune.py`` on the port (collected from
  their source, without its ``slow`` mark; ``_coarse`` hands the port the
  JAX package's k-means centroids).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_ivf_pq import carry
from test_torch_pq_codec import one_thread, port_cases
from tpu_search.index.ivf import IVFIndex as JaxIVF
from tpu_search.index.ivf import tune_pq_config as jax_tune
from tpu_search.ops.kmeans import kmeans as jax_kmeans
from tpu_search_torch.index.ivf import deployed_quant_calibration
from tpu_search_torch.index.ivf import tune_pq_config as port_tune

DIM, K = 32, 10


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The port's indexes and engines default to the CPU here (their
    module-scoped fixtures included), on one thread (``one_thread``)."""
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        yield


def _coarse(rows, nlist, seed=0):
    """The JAX package's k-means centroids, as numpy."""
    centroids, _ = jax_kmeans(jax.random.PRNGKey(seed), jnp.asarray(rows),
                              nlist, iters=10, metric="ip")
    return np.asarray(centroids)


_CASES = port_cases("test_pq_autotune", overrides={"_coarse": _coarse})
globals().update(_CASES)
_clustered = _CASES["_clustered"]


def _uniform(n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, DIM)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


CORPORA = {
    "easy": (lambda: _clustered(1500, DIM, 12, sigma=0.3), 16, 0.3, 0),
    "impossible": (lambda: _uniform(1200, 1), 16, 0.99, 1),
    "clustered": (lambda: _clustered(1000, DIM, 8, sigma=0.5, seed=2), 8,
                  0.95, 2),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_tune_pq_config_chooses_as_jax(name):
    make, nlist, target, seed = CORPORA[name]
    rows = make()
    cents = _coarse(rows, nlist)
    kw = dict(dim=DIM, by_residual=True, target_recall=target, k=K,
              seed=seed)
    want = jax_tune(rows, jnp.asarray(cents), "ip", **kw)
    got = port_tune(rows, cents, "ip", **kw)
    assert (got["pq_m"], got["opq"], got["refine_factor"]) == (
        want["pq_m"], want["opq"], want["refine_factor"])
    assert got["sampled"] == want["sampled"]
    assert len(got["report"]) == len(want["report"])
    for g, w in zip(got["report"], want["report"]):
        assert {k: g[k] for k in ("pq_m", "opq")} == {
            k: w[k] for k in ("pq_m", "opq")}
        assert abs(g["recall"] - w["recall"]) <= (0.05 if w["opq"] else 0.01)
    assert (got["rot"] is None) == (want["rot"] is None)
    assert tuple(got["books"].shape) == tuple(want["books"].shape)


def test_deployed_calibration_on_a_pq_index():
    rows = _clustered(1500, DIM, 12, sigma=0.6, seed=7)
    j = JaxIVF(DIM, dtype="pq", nlist=8, pq_auto=True, pq_target_recall=0.9)
    j.add(rows)
    assert j.refine_dtype == "int8"
    t = carry(j)
    assert t.pq_auto and t._pq_tune_report == j._pq_tune_report
    want = j.calibrate_quant(target_recall=0.9)
    got = deployed_quant_calibration(t, target_recall=0.9)
    assert got["calibrated"] and want["calibrated"]
    for key in ("target", "sampled", "refine_factor", "nprobe", "live",
                "target_unreachable"):
        assert got[key] == want[key], key
    assert abs(got["recall"] - want["recall"]) <= 0.02
    assert (t.refine_factor, t.nprobe_hint) == (j.refine_factor,
                                                j.nprobe_hint)
