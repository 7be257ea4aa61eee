"""dispatch.upload_ms_per_batch.720: the two `.to(dev)` uploads as the host sees them, which hold any wait of the pageable copy on the previous batch's step
(`dispatch.upload` in summary.json's stages, a StageTimer span inside
`dispatch`, host clock), in ms a batch over the window's clips; None
where no clip has the span."""


def read(ctx):
    stages = [s["stages"]["dispatch.upload"] for s in ctx["summaries"]
              if "dispatch.upload" in s["stages"]]
    count = sum(st["count"] for st in stages)
    return sum(st["total_s"] for st in stages) / count * 1e3 if count else None
