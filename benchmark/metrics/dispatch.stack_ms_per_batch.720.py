"""dispatch.stack_ms_per_batch.720: the frames gathered and stacked on the host (`np.stack` of both halves)
(`dispatch.stack` in summary.json's stages, a StageTimer span inside
`dispatch`, host clock), in ms a batch over the window's clips; None
where no clip has the span."""


def read(ctx):
    stages = [s["stages"]["dispatch.stack"] for s in ctx["summaries"]
              if "dispatch.stack" in s["stages"]]
    count = sum(st["count"] for st in stages)
    return sum(st["total_s"] for st in stages) / count * 1e3 if count else None
