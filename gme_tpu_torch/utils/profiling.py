"""Tracing and timing for the results driver.

Counterpart of `gme_tpu/utils/profiling.py`: the reference's wall-time
print decorator (reference utils.py:79-97), a per-stage wall-time
accumulator whose totals land in summary.json (each stage also a
`torch.profiler.record_function` range, where the JAX package opens a
`jax.named_scope`), and an optional `torch.profiler` trace of a region.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from functools import wraps
from typing import Dict, Optional

import torch


def timer(func):
    """Wall-time print decorator (reference utils.py:79-97)."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        ret = func(*args, **kwargs)
        end = time.perf_counter()
        print(f"Execution of '{func.__name__}' in {end - start:.3f}s")
        return ret

    return wrapper


class StageTimer:
    """Accumulates wall time per named stage.  Thread-safe: the driver's
    main thread and its writer thread time their own stages."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        """Account time measured elsewhere (e.g. on a background decode
        thread) under a named stage."""
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + count

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": self.totals[name],
                    "count": self.counts[name],
                    "mean_s": self.totals[name] / max(1, self.counts[name]),
                }
                for name in self.totals
            }


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], cuda: bool = False):
    """Trace the region with `torch.profiler` (CPU activity, and CUDA
    activity when `cuda`) and export it as a Chrome trace,
    `<profile_dir>/trace.json`, when a directory is given.  The CPU side
    holds the ranges of the thread that opened the region; stages timed
    on other threads appear only in the `StageTimer` totals."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
