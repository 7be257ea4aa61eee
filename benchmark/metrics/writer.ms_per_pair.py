"""writer.ms_per_pair: the writer thread's images and records
(`write_outputs` in summary.json's stages, StageTimer, host clock) over
the window's clips, in ms a pair."""


def read(ctx):
    pairs = sum(s["pairs_processed"] for s in ctx["summaries"])
    total = sum(s["stages"].get("write_outputs", {}).get("total_s", 0.0)
                for s in ctx["summaries"])
    return total / pairs * 1e3 if pairs else None
