"""device.busy_ms_per_pair: the union of each card's own activity
intervals (kernels, copies, fills) in the profiled clip, summed over the
cards, over the clip's pairs, in ms."""

from benchmark import trace


def read(ctx):
    t = ctx["traced"]
    busy_us = sum(trace.busy_intervals(t["events"], c)[0] for c in t["cards"])
    return busy_us / 1e3 / t["pairs"] if busy_us > 0 and t["pairs"] else None
