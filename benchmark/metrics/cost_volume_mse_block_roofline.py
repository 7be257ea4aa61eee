"""cost_volume_mse_block_roofline: the share, in %, of the least time the
card could take for the launches of `cost_volume_mse_block` (#2, the
levels' volumes: levels 1 and 2 of each batch on each card) in the
profiled clip, of the device time those launches took, found by kernel
symbol.  The least time is `roofline.volume_bound_ms` at the
configuration's shapes: both inputs read once and the float32 volume
written once at 3.35 TB/s.  Nothing is read where the launches are not two
a batch, one per finer level (the kernel left the path or changed its
split)."""

import math

from benchmark import roofline

SYMBOL = "cost_volume_mse_block"


def read(ctx):
    cfg, t = ctx["config"], ctx["traced"]
    launches = [e for e in t["events"] if SYMBOL in e.name]
    pipe, gme = cfg["pipeline"], cfg["gme"]
    per_card = pipe["batch_size"] // pipe["mesh"]["data"]
    batches = math.ceil(t["pairs"] / pipe["batch_size"])
    levels = roofline.pyramid_shapes(cfg["frame"]["height"], cfg["frame"]["width"],
                                     gme["pyramid_levels"])[1:]
    if not launches or len(launches) != batches * len(levels) * len(t["cards"]):
        return None
    bound_ms = sum(roofline.volume_bound_ms(SYMBOL, per_card, H, W, gme["block_size"],
                                            gme["volume_radius"])[0] for H, W in levels)
    bound_ms *= batches * len(t["cards"])
    device_ms = sum(e.end_us - e.start_us for e in launches) / 1e3
    return 100.0 * bound_ms / device_ms
