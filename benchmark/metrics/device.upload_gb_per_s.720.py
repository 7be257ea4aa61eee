"""device.upload_gb_per_s.720: the bytes uploaded to the card
(`counters.h2d_bytes` in summary.json) over the uploads' device time
(`device.upload_s`: CUDA events before and after each batch's upload), in
GB/s over the window's clips; None where no clip has both."""


def read(ctx):
    clips = [s for s in ctx["summaries"] if "device" in s and "counters" in s]
    seconds = sum(s["device"]["upload_s"] for s in clips)
    nbytes = sum(s["counters"]["h2d_bytes"] for s in clips)
    return nbytes / seconds / 1e9 if seconds > 0 else None
