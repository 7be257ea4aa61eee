"""device.idle_decode_share.720: the share of the card's idle time between
batches (`device.idle_s` in summary.json, by CUDA events) that the main
thread spent waiting for decoded frames or starting the call
(`decode_wait` and `startup` of `device.idle_by_stage_s`), over the
window's clips; None where no clip has it."""

STAGES = ("decode_wait", "startup")


def read(ctx):
    clips = [s["device"] for s in ctx["summaries"] if "device" in s]
    idle = sum(d["idle_s"] for d in clips)
    part = sum(d["idle_by_stage_s"].get(k, 0.0) for d in clips for k in STAGES)
    return part / idle if idle > 0 else None
