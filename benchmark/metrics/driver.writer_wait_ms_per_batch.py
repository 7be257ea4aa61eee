"""driver.writer_wait_ms_per_batch: the main thread's wait on the writer
thread's previous batch (`writer_wait` in summary.json's stages, a
StageTimer span, host clock), in ms a batch over the window's clips; None
where no clip has the span."""


def read(ctx):
    stages = [s["stages"]["writer_wait"] for s in ctx["summaries"]
              if "writer_wait" in s["stages"]]
    count = sum(st["count"] for st in stages)
    return sum(st["total_s"] for st in stages) / count * 1e3 if count else None
