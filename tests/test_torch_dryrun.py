"""The port's multi-device dry run (``tpu_search_torch.parallel.dryrun``),
the counterpart of ``__graft_entry__.dryrun_multichip``, on 8 shards of
the CPU (a 4 x 2 mesh: the train step with dp and tp), in a process of
its own that never imports jax: every step's asserts hold and it prints
the JAX dry run's closing line."""

import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent

CODE = """
import sys
from tpu_search_torch.parallel.dryrun import dryrun_multichip
line = dryrun_multichip(8, "cpu")
assert "jax" not in sys.modules and "tpu_search" not in sys.modules
print("NO_JAX_OK")
"""


def test_dryrun_multichip_8_on_the_cpu(tmp_path):
    env = {"CLAUDE_SEARCH_DEVICE": "cpu", "PATH": "/usr/bin:/bin",
           "PYTHONPATH": str(REPO_ROOT), "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    done = subprocess.run([sys.executable, "-c", CODE], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    out = done.stdout + done.stderr
    assert done.returncode == 0, out[-4000:]
    assert "dryrun_multichip OK: mesh={'data': 4, 'model': 2} loss=" in out
    assert "sharded serving top1=chunk_" in out
    assert "NO_JAX_OK" in out
