"""compiled.capture_s: the seconds the process has spent capturing CUDA
graphs (`counters.process_capture_s` in summary.json, from
`gme_tpu_torch.utils.compiled.capture_stats`, host clock), as the window's
last clip read it: the warm-up's captures, and any made inside the window;
None where the counter is absent."""


def read(ctx):
    counters = ctx["summaries"][-1].get("counters", {}) if ctx["summaries"] else {}
    return counters.get("process_capture_s")
