"""Reduction of a `torch.profiler` trace to device busy time, idle gaps and
the breakdown the result line carries.

`busy_intervals` is a frozen copy of `chip_smoke.busy_intervals`, split so
that the arithmetic runs on plain (start, end) spans: the union of the
device's own activity intervals (kernels, copies, fills), never a sum of
`key_averages()` rows, which list each aten op and its kernels both.  The
CPU operator rows are not read, except the host ranges (`record_function`)
that name an idle gap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Span = Tuple[float, float]

# The driver's StageTimer ranges (gme_tpu_torch/utils/profiling.py): the
# host work an idle gap of the device is named by.
HOST_RANGES = ("decode_wait", "dispatch", "device_get", "write_outputs")


@dataclass
class DeviceEvent:
    name: str
    device: int
    start_us: float
    end_us: float


@dataclass
class HostRange:
    name: str
    start_us: float
    end_us: float


def union(spans: Sequence[Span]) -> Tuple[float, List[Span]]:
    """(total length, merged spans) of the union of `spans`."""
    merged: List[List[float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def busy_intervals(events: Sequence[DeviceEvent], device: Optional[int] = None
                   ) -> Tuple[float, Dict[str, float]]:
    """(busy us, {name: us}) of the device events (of one card where
    `device` is given): the union of their intervals, and each name's
    total."""
    spans, by_name = [], {}
    for e in events:
        if device is not None and e.device != device:
            continue
        spans.append((e.start_us, e.end_us))
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us)
    busy, _ = union(spans)
    return busy, by_name


def idle_gaps(events: Sequence[DeviceEvent], device: int, span: Span) -> List[Span]:
    """The intervals of `span` in which card `device` ran nothing."""
    _, merged = union([(e.start_us, e.end_us) for e in events if e.device == device])
    gaps, reach = [], span[0]
    for s, e in merged:
        if s > reach:
            gaps.append((reach, min(s, span[1])))
        reach = max(reach, e)
    if reach < span[1]:
        gaps.append((reach, span[1]))
    return [g for g in gaps if g[1] > g[0]]


def name_gap(gap: Span, ranges: Sequence[HostRange]) -> str:
    """What the host did for most of `gap`: the driver's range
    (`HOST_RANGES`) that covers the most of it, or "host" where the part
    that no such range covers is larger (the profiler sees the ranges of
    the thread that opened it only, so there the main thread waits or works
    outside a stage)."""
    cover: Dict[str, float] = {}
    for r in ranges:
        if r.name in HOST_RANGES:
            c = min(gap[1], r.end_us) - max(gap[0], r.start_us)
            if c > 0:
                cover[r.name] = cover.get(r.name, 0.0) + c
    cover["host"] = (gap[1] - gap[0]) - sum(cover.values())
    return max(cover, key=cover.get)


def breakdown(events: Sequence[DeviceEvent], ranges: Sequence[HostRange],
              devices: Sequence[int], span: Span, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of any card, each named by the host range around it; seconds."""
    _, by_name = busy_intervals(events)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(name_gap(g, ranges), g[1] - g[0]) for d in devices for g in idle_gaps(events, d, span)]
    gaps.sort(key=lambda kv: -kv[1])
    return {
        "device_ops": [[n, us / 1e6] for n, us in ops],
        "idle_gaps": [[n, us / 1e6] for n, us in gaps[:top]],
    }


def kind(name: str) -> str:
    """A device activity's kind by its name: "copy" (`Memcpy ...`, to, from
    or within the card), "fill" (`Memset ...`) or "kernel"."""
    return "copy" if name.startswith("Memcpy") else "fill" if name.startswith("Memset") else "kernel"


def read_device_spans(prof) -> Dict[Tuple[int, str], List[Span]]:
    """The device's own activity intervals (ns) of a finished
    `torch.profiler.profile`, by card and `kind`, read from its Kineto
    results without the per-operator event tree, which a whole window's
    million-odd launches would make slow to build.  User annotations are
    left out, as in `read_profile`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans: Dict[Tuple[int, str], List[Span]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            spans.setdefault((e.device_index(), kind(e.name())), []).append(
                (e.start_ns(), e.end_ns()))
    return spans


def union_length(spans: Sequence[Span]) -> float:
    """The length of the union of `spans`, as `union` gives it, computed
    on arrays: a run of overlapping spans ends where the next starts past
    every earlier end.  Whole-number spans stay int64, exact at the
    profiler's epoch nanoseconds, where a float64 rounds to 256 ns."""
    if not len(spans):
        return 0.0
    a = np.asarray(spans)
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    first = np.ones(len(a), dtype=bool)
    first[1:] = a[1:, 0] > reach[:-1]
    last = np.append(np.flatnonzero(first)[1:] - 1, len(a) - 1)
    return float((reach[last] - a[first, 0]).sum())


def device_ms_per_pair(spans: Dict[Tuple[int, str], List[Span]], devices: Sequence[int],
                       pairs: int, kinds: Sequence[str] = ("kernel", "copy", "fill")
                       ) -> Optional[float]:
    """Each card's busy time in the activities of `kinds` (the union of
    their intervals, in ns), summed over the cards, over `pairs`, in ms;
    None where nothing ran."""
    busy_ns = sum(union_length([s for k in kinds for s in spans.get((d, k), [])])
                  for d in devices)
    return busy_ns / 1e6 / pairs if busy_ns > 0 and pairs else None


def read_profile(prof, host_names: Sequence[str] = HOST_RANGES
                 ) -> Tuple[List[DeviceEvent], List[HostRange]]:
    """The device's own activity (kernels, copies, fills) and the named
    host ranges of a finished `torch.profiler.profile`.  A
    `record_function` range open on the host also appears on the device's
    timeline as a user annotation spanning all it encloses; that is no
    activity of the device and is left out."""
    import torch

    events = list(prof.events())
    annotations = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                   and e.name in host_names}
    dev_events, ranges = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in annotations:
                continue
            dev_events.append(DeviceEvent(e.name, e.device_index, e.time_range.start,
                                          e.time_range.end))
        elif e.name in host_names:
            ranges.append(HostRange(e.name, e.time_range.start, e.time_range.end))
    return dev_events, ranges
