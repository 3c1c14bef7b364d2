"""Per-phase wall-time accounting for the indexing stats, and device
traces (the ``PhaseTimer`` and ``device_trace`` of
``tpu_search/utils/profiling.py``; the traces come from ``torch.profiler``
in place of ``jax.profiler``)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

logger = logging.getLogger(__name__)

__all__ = ["PhaseTimer", "device_trace"]


@dataclass
class PhaseTimer:
    """Accumulates wall time + call counts per named phase.

    Used by the engine to report parse/chunk/tokenize/encode/index phase
    breakdowns in indexing stats.
    """

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Any]:
        total = sum(self.phases.values()) or 1.0
        return {
            name: {
                "seconds": round(seconds, 4),
                "calls": self.counts[name],
                "fraction": round(seconds / total, 3),
            }
            for name, seconds in sorted(
                self.phases.items(), key=lambda kv: -kv[1]
            )
        }

    def merge(self, other: "PhaseTimer") -> None:
        for name, seconds in other.phases.items():
            self.phases[name] = self.phases.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + other.counts[name]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (host and, where
    CUDA is available, device activity) into ``log_dir/trace.json``, a
    Chrome trace Perfetto opens; a no-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Device trace written to %s", path)
