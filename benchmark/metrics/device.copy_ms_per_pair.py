"""device.copy_ms_per_pair: the union of each card's copies' intervals
(`Memcpy ...`: the pageable upload of each batch's frames, the outputs'
copy back) in the profiled clip, summed over the cards, over the clip's
pairs, in ms: the card's time that `kernel_ms_per_pair` leaves out, whose
length follows the host's memory speed."""

from benchmark import trace


def read(ctx):
    t = ctx["traced"]
    copies = [e for e in t["events"] if trace.kind(e.name) == "copy"]
    busy_us = sum(trace.busy_intervals(copies, c)[0] for c in t["cards"])
    return busy_us / 1e3 / t["pairs"] if busy_us > 0 and t["pairs"] else None
