"""driver.pairs_per_s: every pair of the window's clips over their whole
time, host clock, as `pairs_per_s` reads it where it is an end-to-end
metric, the profiled clip left out.  It stands here in a cell whose
host's speed swings between runs more than any bound allows, beside
`kernel_ms_per_pair`."""


def read(ctx):
    w = ctx["window"]
    return w["pairs"] / w["seconds"] if w["pairs"] and w["seconds"] > 0 else None
