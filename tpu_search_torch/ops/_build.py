"""Build and load the hand-written CUDA kernels in ``tpu_search_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
(:data:`LIBRARIES`) with a plain C interface under ``build/kernels/`` at the
repository root, on first use, and loads through ``ctypes``.  The library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel rebuilds and a stale one is never loaded.
Nothing here builds at import time: the CPU tests import every module on
a machine without ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into a ``RuntimeError``.  The kernels
use the CUDA runtime alone: none takes a TMA tensor map (the int8 GEMM's
``wgmma`` ring fills by ``cp.async``), so nothing links the driver library
or asks it for ``cuTensorMapEncodeTiled``.

Each wrapper counts its own launches in :data:`LAUNCHES`, one key a kernel
of :data:`KERNELS`, so a run can show that the main path went through the
kernels.  A CUDA graph replay (``api/fused.py``) launches without calling
the wrappers: it adds the counts its capture recorded, and the capture,
which launches nothing, leaves the counts as they were.  A process that
serves searches for another (``cli serve``, the MCP server) writes its
counts as JSON to ``$CLAUDE_SEARCH_LAUNCH_LOG`` when it exits, where that
variable is set, so its caller can read which kernels it launched.
Each kernel's export is in the library of its name, except
``int8_ffn_in``'s, ``int8_ffn_out``'s and ``int8_ffn_fused``'s, which run
on ``int8_ffn_ln``'s GEMM loops and are in that library
(``ops/int8_gemm._LIBRARY``).
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "LIBRARIES",
    "build_all",
    "check",
    "library",
    "multiprocessors",
    "reset_launches",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# The port's kernels, one launch counter each.
KERNELS = ("flat_topk", "mpnet_attention", "int8_ffn_ln", "flat_topk_int8",
           "flat_topk_int4", "ivf_topk", "ivf_topk_int8", "ivf_topk_int4",
           "mpnet_attention_bhsd", "int8_gemm", "int8_ffn_in", "int8_ffn_out",
           "int8_ffn_fused", "flash_attention", "int4_probe",
           "scan_overhead_probe")
# One library per kernel source.
LIBRARIES = tuple(sorted(path.stem for path in CSRC.glob("*.cu")))

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
_SMS: Dict[int, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _write_launch_log(path: str) -> None:
    Path(path).write_text(json.dumps(LAUNCHES))


if os.environ.get("CLAUDE_SEARCH_LAUNCH_LOG"):
    atexit.register(_write_launch_log, os.environ["CLAUDE_SEARCH_LAUNCH_LOG"])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA "
        "toolkit (PATH or /usr/local/cuda/bin)"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str) -> subprocess.Popen:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.kernel_out, proc.kernel_tmp = out, tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.kernel_tmp, proc.kernel_out)  # type: ignore[attr-defined]
    return log


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source that has no current library, in
    parallel.  Returns ``{"seconds": wall time, "logs": {name: nvcc
    output}}`` (the ptxas register, spill and shared-memory report of each
    source compiled now); prints the logs when ``verbose``."""
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    with _lock:
        procs = {
            name: _compile(name)
            for name in LIBRARIES
            if not _target(name).exists()
        }
        for name, proc in procs.items():
            logs[name] = _finish(name, proc)
            if verbose:
                print(f"[build] {name}.cu\n{logs[name]}")
        for name in LIBRARIES:
            library(name)
    return {"seconds": time.perf_counter() - start, "logs": logs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(name, _compile(name))
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def multiprocessors(device) -> int:
    """The streaming multiprocessors of a CUDA device; cached, so a scan's
    wrapper asks the driver once a device, not once a call."""
    import torch

    device = torch.device(device)
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]
