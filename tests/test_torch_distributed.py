"""The port's multi-process layer: two local processes in one gloo group.

What ``tests/test_distributed.py`` does for the JAX package's flat index:
each process has 4 CPU devices (``XLA_FLAGS``), joins the group through
``initialize_distributed`` (a second call is a no-op), builds
``build_mesh(n_data=8, dcn_data=2)`` (process p owns shards 4p .. 4p + 3),
and runs the sharded index add -> search -> per-process save ->
per-process load -> search in every dtype, each answer against a local
reference: the same rows in an 8-shard index held whole by the process,
which merges in the same shard order, so scores and ids must be equal
(and for float32 the ids of a plain numpy argsort too).  Removals count
live rows across both processes.  Then the sharded IVF index the same way
(f32 and int8, as ``tests/test_distributed.py`` drives the JAX one), and
its lifecycle: pq with the int8 refine tier, ``tune_nprobe``, per-process
files, a skewed add and ``rebalance`` on the loaded index, each answer and
report equal to the local reference's.

The workers import torch and the port only, never jax; each process has a
120 s timeout and the test takes a few seconds.  In this process, with no
group: process 0 of 1, ``initialize_distributed`` refusing to start
without its three settings, and ``build_mesh``'s shapes and error messages
against the JAX function's.
"""

import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from tpu_search.parallel import build_mesh as jax_build_mesh
from tpu_search_torch.parallel import (
    build_mesh,
    initialize_distributed,
    is_distributed,
    process_count,
    process_index,
)

REPO_ROOT = Path(__file__).resolve().parent.parent

WORKER = r"""
import os, sys
import numpy as np
import torch

pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]

from tpu_search_torch.index.serialize import read_file
from tpu_search_torch.parallel import (
    ShardedFlatIndex, build_mesh, initialize_distributed, is_distributed,
    process_count, process_index,
)

initialize_distributed(coordinator_address=f"localhost:{port}",
                       num_processes=2, process_id=pid)
initialize_distributed(coordinator_address=f"localhost:{port}",
                       num_processes=2, process_id=pid)  # logged, ignored
assert is_distributed() and process_count() == 2 and process_index() == pid

mesh = build_mesh(n_data=8, dcn_data=2)
assert mesh.shape == {"data": 8, "model": 1}, mesh.shape
assert mesh.local_shards() == tuple(range(4 * pid, 4 * pid + 4))
local = build_mesh(n_data=8, devices=[torch.device("cpu")] * 8)

rng = np.random.default_rng(0)  # the same data on both processes
d = 32
vecs = rng.standard_normal((300, d)).astype(np.float32)
vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
queries = rng.standard_normal((3, d)).astype(np.float32)
queries /= np.linalg.norm(queries, axis=1, keepdims=True)
mask = np.zeros(300, bool)
mask[::7] = True

def same(a, b, what):
    assert np.array_equal(a[1], b[1]), (what, a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0], err_msg=what)

for dtype in ("float32", "bfloat16", "int8", "int4"):
    index = ShardedFlatIndex(dim=d, mesh=mesh, dtype=dtype)
    ref = ShardedFlatIndex(dim=d, mesh=local, dtype=dtype)
    assert list(index.add(vecs)) == list(ref.add(vecs)) == list(range(300))
    got = index.search(queries, k=5)
    same(got, ref.search(queries, k=5), dtype)
    if dtype == "float32":
        want = np.argsort(-(queries @ vecs.T), axis=1, kind="stable")[:, :5]
        assert np.array_equal(got[1], want), (got[1], want)

    masked = index.search(queries, k=4, mask=mask)
    assert (masked[1][masked[1] >= 0] % 7 == 0).all()
    same(masked, ref.search(queries, k=4, mask=mask), dtype + " masked")

    assert index.remove([0, 5, 9, 299]) == ref.remove([0, 5, 9, 299]) == 4
    assert index.live == ref.live == 296 and index.ntotal == 300

    path = os.path.join(out_dir, f"dist_{dtype}.tpuidx")
    index.save(path)  # ends on a barrier: both files exist now
    header, arrays = read_file(path + f".host{pid}")
    assert header["kind"] == "flat_shards_host"
    assert header["shard_ids"] == list(range(4 * pid, 4 * pid + 4))
    assert os.path.exists(path + f".host{1 - pid}")
    loaded = ShardedFlatIndex.load(path, mesh=mesh)
    assert loaded.live == 296 and loaded.capacity == index.capacity
    same(loaded.search(queries, k=5), ref.search(queries, k=5),
         dtype + " loaded")
    same(loaded.search(queries, k=4, mask=mask),
         ref.search(queries, k=4, mask=mask), dtype + " loaded masked")
    new = loaded.add(vecs[:4])
    assert list(new) == [300, 301, 302, 303]
    top = loaded.search(vecs[1], k=2)[1][0]
    assert sorted(top.tolist()) == [1, 301], top

# Sharded IVF (the JAX case of tests/test_distributed.py on the port):
# add -> search -> per-process save -> per-process load -> search, each
# answer against the same rows in a one-process index over `local`.
from tpu_search_torch.parallel import ShardedIVFIndex

for dtype in ("float32", "int8"):
    ivf = ShardedIVFIndex(dim=d, mesh=mesh, dtype=dtype, nlist=4, seed=3)
    ref = ShardedIVFIndex(dim=d, mesh=local, dtype=dtype, nlist=4, seed=3)
    assert list(ivf.add(vecs)) == list(ref.add(vecs))
    np.testing.assert_array_equal(ivf._ids, ref._ids)
    assert sorted(ivf._shards) == list(range(4 * pid, 4 * pid + 4))
    got = ivf.search(queries, k=5, nprobe=4)  # exhaustive probe
    same(got, ref.search(queries, k=5, nprobe=4), "ivf " + dtype)
    if dtype == "float32":
        want = np.argsort(-(queries @ vecs.T), axis=1)[:, :5]
        assert sorted(got[1][0]) == sorted(want[0]), (got[1], want)
    same(ivf.search(queries, k=4, mask=mask, nprobe=4),
         ref.search(queries, k=4, mask=mask, nprobe=4), "ivf masked")
    path = os.path.join(out_dir, f"ivf_{dtype}.tpuidx")
    ivf.save(path)
    header, _ = read_file(path + f".host{pid}")
    assert header["kind"] == "ivf_shards_host"
    assert header["shard_ids"] == list(range(4 * pid, 4 * pid + 4))
    loaded = ShardedIVFIndex.load(path, mesh=mesh)
    assert loaded.ntotal == ivf.ntotal and loaded.live == ivf.live
    same(loaded.search(queries, k=5, nprobe=4), got, "ivf loaded " + dtype)
    # The loaded index stays mutable (its host metadata copies, not the
    # file's read-only maps).
    new_ids = loaded.add(vecs[:4])
    assert loaded.remove(new_ids[:2]) == 2
    assert loaded.search(vecs[0], k=1, nprobe=4)[1][0, 0] == 0

# The whole IVF lifecycle across the two processes: pq with the int8
# refine tier, the nprobe autotune, per-process files, rebalance.
kw = dict(dim=d, dtype="pq", nlist=4, seed=3, refine_dtype="int8",
          refine_factor=8)
ivf = ShardedIVFIndex(mesh=mesh, **kw)
ref = ShardedIVFIndex(mesh=local, **kw)
ivf.add(vecs)
ref.add(vecs)
tune = ivf.tune_nprobe(target_recall=0.9, k=5)
assert tune["tuned"] and tune == ref.tune_nprobe(target_recall=0.9, k=5)
pre = ivf.search(queries, k=5, nprobe=4)
same(pre, ref.search(queries, k=5, nprobe=4), "pq refine")
path = os.path.join(out_dir, "ivf_lifecycle.tpuidx")
ivf.save(path)
loaded = ShardedIVFIndex.load(path, mesh=mesh)
assert loaded.nprobe_hint == ivf.nprobe_hint
assert (loaded.refine_dtype, loaded.refine_factor) == ("int8", 8)
assert loaded._refine.count == loaded.live == 300
same(loaded.search(queries, k=5, nprobe=4), pre, "pq refine loaded")
hot = vecs[0] + 0.01 * rng.standard_normal((80, d)).astype(np.float32)
hot /= np.linalg.norm(hot, axis=1, keepdims=True)
loaded.add(hot)
ref.add(hot)
ref.seed = loaded.seed  # a loaded index retrains from the default seed
report = loaded.rebalance(train_sample=400)
assert report == ref.rebalance(train_sample=400)
assert report["filled"] == 380 and loaded.live == 380
after = loaded.search(queries, k=5, nprobe=4)
same(after, ref.search(queries, k=5, nprobe=4), "pq refine rebalanced")
assert list(loaded.search(vecs[5:9], k=1, nprobe=4)[1][:, 0]) == [5, 6, 7, 8]
path2 = os.path.join(out_dir, "ivf_lifecycle2.tpuidx")
loaded.save(path2)
same(ShardedIVFIndex.load(path2, mesh=mesh).search(queries, k=5, nprobe=4),
     after, "pq refine rebalanced, loaded")

assert "jax" not in sys.modules
torch.distributed.destroy_process_group()
print(f"WORKER_{pid}_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_index(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "CLAUDE_SEARCH_DEVICE": "cpu",
        "OMP_NUM_THREADS": "1",
        "PATH": "/usr/bin:/bin",
        "PYTHONPATH": str(REPO_ROOT),
        "HOME": str(tmp_path),
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO_ROOT,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER_{pid}_OK" in out
    # the manifest written once, a file by each process
    for stem in ("dist_float32", "dist_bfloat16", "dist_int8", "dist_int4",
                 "ivf_float32", "ivf_int8", "ivf_lifecycle",
                 "ivf_lifecycle2"):
        for name in ("", ".host0", ".host1"):
            assert (tmp_path / f"{stem}.tpuidx{name}").exists()


def test_without_a_group(monkeypatch):
    """No group: process 0 of 1; ``initialize_distributed`` with nothing
    to join raises, and leaves no group behind."""
    for name in ("TPU_SEARCH_COORDINATOR", "TPU_SEARCH_NUM_PROCESSES",
                 "TPU_SEARCH_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert (process_index(), process_count(), is_distributed()) == (
        0, 1, False)
    with pytest.raises(ValueError, match="coordinator address"):
        initialize_distributed()
    assert not dist.is_initialized()


def test_build_mesh_checks_match_jax(monkeypatch):
    """The port's ``build_mesh`` over 8 CPU devices: the JAX function's
    shapes and error messages on the same arguments."""
    monkeypatch.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
    for kwargs in ({}, {"n_data": 4}, {"n_data": 4, "n_model": 2},
                   {"n_model": 2}):
        want = dict(jax_build_mesh(**kwargs).shape)
        assert build_mesh(**kwargs).shape == want
    for kwargs in ({"n_data": 9}, {"n_data": 5, "n_model": 2},
                   {"n_data": 7, "dcn_data": 2}):
        with pytest.raises(ValueError) as want:
            jax_build_mesh(**kwargs)
        with pytest.raises(ValueError) as got:
            build_mesh(**kwargs)
        assert str(got.value) == str(want.value)
