"""device.idle_writer_share: the share of the card's idle time between
batches (`device.idle_s` in summary.json, by CUDA events) that the main
thread spent waiting on the writer thread (`writer_wait` of
`device.idle_by_stage_s`), over the window's clips; None where no clip
has it."""


def read(ctx):
    clips = [s["device"] for s in ctx["summaries"] if "device" in s]
    idle = sum(d["idle_s"] for d in clips)
    part = sum(d["idle_by_stage_s"].get("writer_wait", 0.0) for d in clips)
    return part / idle if idle > 0 else None
