"""device.idle_share: 1 - busy / (cards x the profiled clip's wall), with
busy the union of each card's own activity intervals in that clip."""

from benchmark import trace


def read(ctx):
    t = ctx["traced"]
    start, end = t["span_us"]
    busy_us = sum(trace.busy_intervals(t["events"], c)[0] for c in t["cards"])
    if busy_us <= 0 or end <= start:
        return None
    return 1.0 - busy_us / (len(t["cards"]) * (end - start))
