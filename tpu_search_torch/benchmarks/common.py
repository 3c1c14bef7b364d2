"""What the bulk-build benchmark scripts share: their device (the card
unless the caller asks for the CPU), timers, the card's name and power
limit, recall, the on-device clustered corpus and the JSON output."""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices.capability import resolve_device

__all__ = ["HBM_BYTES_PER_S", "bench_device", "card", "clustered_corpus",
           "emit", "recall_at", "sync", "timed_ms", "unit_rows"]

# The H100 SXM's HBM3 rate (NVIDIA data sheet): the bytes bound's divisor.
HBM_BYTES_PER_S = 3.35e12


def bench_device(name: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; ``cuda`` without a card raises:
    a script never falls back to the CPU on its own."""
    return resolve_device(name)


def card() -> Optional[str]:
    """``name, power limit`` of the first card as ``nvidia-smi`` gives
    them, or None where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn: Callable[[], object], reps: int,
             device: torch.device) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm call: CUDA
    events on the card's stream, the host's clock on the CPU."""
    fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def recall_at(got: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Mean over queries of ``|got[:k] & truth[:k]| / k``."""
    return float(np.mean([len(set(g[:k].tolist()) & set(t[:k].tolist())) / k
                          for g, t in zip(got, truth)]))


def unit_rows(gen: torch.Generator, n: int, d: int,
              device: torch.device) -> torch.Tensor:
    """``n`` Gaussian rows scaled to unit norm, on ``device``."""
    rows = torch.randn((n, d), generator=gen, device=device)
    return rows / rows.norm(dim=1, keepdim=True)


def clustered_corpus(n: int, dim: int, clusters: int, noise: float,
                     queries: int, seed: int, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blob corpus of the JAX package's ``ivf_sweep.py`` and
    ``bench.py`` IVF section, made on ``device`` from one seeded
    generator: unit centres, each row a random centre plus Gaussian noise
    of relative norm ``noise``, renormalized; queries are random rows plus
    noise of relative norm 0.2, renormalized.  ``(corpus [n, dim] f32,
    queries [queries, dim] f32)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = unit_rows(gen, clusters, dim, device)
    assign = torch.randint(0, clusters, (n,), generator=gen, device=device)
    corpus = centres[assign]
    corpus += (noise / np.sqrt(dim)) * torch.randn(
        (n, dim), generator=gen, device=device)
    corpus /= corpus.norm(dim=1, keepdim=True)
    pick = torch.randint(0, n, (queries,), generator=gen, device=device)
    q = corpus[pick] + (0.2 / np.sqrt(dim)) * torch.randn(
        (queries, dim), generator=gen, device=device)
    return corpus, q / q.norm(dim=1, keepdim=True)


def emit(out: dict, path: Optional[str] = None,
         lines: Sequence[dict] = ()) -> None:
    """Print ``lines`` then the headline ``out``, one JSON object a line,
    the headline last; write the headline to ``path`` where one is
    given."""
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps(out), flush=True)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(out, indent=1) + "\n")
