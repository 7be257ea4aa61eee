"""decode.wait_ms_per_pair: the main thread's wait for decoded frames
(`decode_wait` in summary.json's stages, StageTimer, host clock) over the
window's clips, in ms a pair."""


def read(ctx):
    pairs = sum(s["pairs_processed"] for s in ctx["summaries"])
    total = sum(s["stages"].get("decode_wait", {}).get("total_s", 0.0) for s in ctx["summaries"])
    return total / pairs * 1e3 if pairs else None
