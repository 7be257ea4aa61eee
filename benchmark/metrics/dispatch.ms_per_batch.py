"""dispatch.ms_per_batch: the main thread's stack, upload and compiled
step (`dispatch` in summary.json's stages, StageTimer, host clock), in ms
a batch over the window's clips."""


def read(ctx):
    stages = [s["stages"]["dispatch"] for s in ctx["summaries"] if "dispatch" in s["stages"]]
    count = sum(st["count"] for st in stages)
    return sum(st["total_s"] for st in stages) / count * 1e3 if count else None
