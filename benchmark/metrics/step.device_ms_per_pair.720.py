"""step.device_ms_per_pair.720: the compiled step's device time by CUDA
events, with no profiler (`device.step_s` in summary.json: events after
each batch's upload and after its step), over the real pairs of the
window's clips, in ms a pair; None where no clip has it.  Read beside the
profiler's `kernel_ms_per_pair`."""


def read(ctx):
    clips = [s for s in ctx["summaries"] if "device" in s]
    pairs = sum(s["pairs_processed"] for s in clips)
    return sum(s["device"]["step_s"] for s in clips) / pairs * 1e3 if pairs else None
