"""Tracing and timing for the results driver.

Counterpart of `gme_tpu/utils/profiling.py`: a per-stage wall-time
accumulator whose totals land in summary.json (each stage also a
`torch.profiler.record_function` range, where the JAX package opens a
`jax.named_scope`), and an optional `torch.profiler` trace of a region.

Each stage is also a span, kept in memory for the life of its
`StageTimer`: its name, thread, start and end (`perf_counter_ns`).  A
thread's spans nest; a child's name is its parent's with a dotted suffix
(`dispatch.stack`), so summary.json's `stages` keeps the parents' keys and
adds the children's.  `attribute_idle` puts the device's idle gaps down to
the spans that cover them.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Span(NamedTuple):
    """One timed stage on `thread` (`threading.get_ident`): `start_ns` and
    `end_ns` on `perf_counter_ns`, read just outside its `record_function`
    range."""

    name: str
    thread: int
    start_ns: int
    end_ns: int


class _Open(NamedTuple):
    name: str
    start_ns: int
    range: object


class StageTimer:
    """Accumulates wall time per named stage and keeps each stage's span.
    Thread-safe: the driver's main, writer and decoder threads time their
    own stages."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def start(self, name: str) -> _Open:
        """Open a span (and its `record_function` range) on this thread.
        Close it with `stop`, innermost first."""
        # The clock is read just outside the range: a range's entry and
        # exit may wait for the interpreter lock, and that wait is the span's.
        rng = torch.profiler.record_function(name)
        span = _Open(name, time.perf_counter_ns(), rng)
        rng.__enter__()
        self._stack().append(span)
        return span

    def stop(self, span: _Open) -> None:
        stack = self._stack()
        if not stack or stack[-1] is not span:
            raise RuntimeError(f"span {span.name!r} closed out of order")
        stack.pop()
        span.range.__exit__(None, None, None)
        end = time.perf_counter_ns()
        done = Span(span.name, threading.get_ident(), span.start_ns, end)
        with self._lock:
            self.spans.append(done)
            self.totals[span.name] = self.totals.get(span.name, 0.0) + (end - span.start_ns) / 1e9
            self.counts[span.name] = self.counts.get(span.name, 0) + 1

    def stage(self, name: str) -> "_Stage":
        """A span around a `with` block."""
        return _Stage(self, name)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        """Account time measured elsewhere (e.g. on a background decode
        thread) under a named stage, with no span."""
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + count

    def thread_spans(self, thread: int) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.thread == thread]

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


class _Stage:
    """`StageTimer.stage`: a slotted context object, which costs a span
    about a third less than a generator's context manager."""

    __slots__ = ("timers", "name", "span")

    def __init__(self, timers: StageTimer, name: str):
        self.timers, self.name = timers, name

    def __enter__(self) -> None:
        self.span = self.timers.start(self.name)

    def __exit__(self, *exc) -> None:
        self.timers.stop(self.span)


def _innermost(spans: Sequence[Span]) -> List[Tuple[int, int, str]]:
    """Nested spans as disjoint (start, end, name) pieces in time order,
    each named by the innermost span that covers it."""
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Span] = []  # the open spans, outermost first
    t = None  # where the pieces emitted so far end

    def emit_until(end: int) -> None:
        nonlocal t
        if stack and end > t:
            pieces.append((t, end, stack[-1].name))
        t = end if t is None else max(t, end)

    # A parent starts no later than its child and ends no earlier.
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            emit_until(stack[-1].end_ns)
            stack.pop()
        emit_until(s.start_ns)
        stack.append(s)
    while stack:
        emit_until(stack[-1].end_ns)
        stack.pop()
    return pieces


def attribute_idle(spans: Sequence[Span], gaps: Sequence[Tuple[int, int]]) -> Dict[str, float]:
    """Seconds of the host intervals `gaps` ((start, end) in
    `perf_counter_ns`) by the innermost of `spans` (one thread's, so
    nested) that covers each instant; "host" where none does.  The values
    sum to the gaps' total length.  One sort of the spans, then a binary
    search a gap: the cost grows with the spans and gaps, not their
    product."""
    pieces = _innermost(spans)
    ends = [b for _, b, _ in pieces]
    out: Dict[str, int] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        uncovered = g1 - g0
        i = bisect.bisect_right(ends, g0)
        while i < len(pieces) and pieces[i][0] < g1:
            a, b, name = pieces[i]
            ns = min(b, g1) - max(a, g0)
            out[name] = out.get(name, 0) + ns
            uncovered -= ns
            i += 1
        if uncovered:
            out["host"] = out.get("host", 0) + uncovered
    return {name: ns / 1e9 for name, ns in out.items()}


def _all_threads_config():
    """The profiler's option to record the ranges of every thread, where
    the installed torch has it; None where it has not."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], cuda: bool = False):
    """Trace the region with `torch.profiler` (CPU activity, and CUDA
    activity when `cuda`) and export it as a Chrome trace,
    `<profile_dir>/trace.json`, when a directory is given.  Where the
    installed torch takes `profile_all_threads`, the CPU side holds the
    ranges of every thread, the driver's writer and decoder threads with
    the main thread, on the device activity's clock; elsewhere the main
    thread's only."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, experimental_config=_all_threads_config()) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
