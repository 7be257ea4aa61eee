"""dispatch.step_ms_per_batch.720: the compiled call on the host: key, copy into the graph's inputs, replay and clones
(`dispatch.step` in summary.json's stages, a StageTimer span inside
`dispatch`, host clock), in ms a batch over the window's clips; None
where no clip has the span."""


def read(ctx):
    stages = [s["stages"]["dispatch.step"] for s in ctx["summaries"]
              if "dispatch.step" in s["stages"]]
    count = sum(st["count"] for st in stages)
    return sum(st["total_s"] for st in stages) / count * 1e3 if count else None
