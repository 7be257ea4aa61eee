"""writer.needle_ms_per_pair: the writer thread's needle diagrams, cv2's
drawing and the BGR PNG it writes itself (`write_outputs.needle` in
summary.json's stages, timed pair by pair inside `write_outputs` and added
up a batch, host clock), in ms a pair over the window's clips; None where
no clip has the stage."""


def read(ctx):
    clips = [s for s in ctx["summaries"] if "write_outputs.needle" in s["stages"]]
    pairs = sum(s["pairs_processed"] for s in clips)
    total = sum(s["stages"]["write_outputs.needle"]["total_s"] for s in clips)
    return total / pairs * 1e3 if pairs else None
