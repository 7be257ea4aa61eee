"""driver.clip_s_p90: the nearest-rank 90th percentile, in s, of the wall
time of one `process_video` call (a whole clip: start-up, loop, summary)
over the window's clips, the profiled clip left out; host clock.  A stall
that the window's rate hides in the mean of 100-odd clips moves it.
Nothing is read from fewer than 20 clips: 10% of them beyond it would be
fewer than two."""

from benchmark.window import nearest_rank


def read(ctx):
    walls = ctx["clip_walls"]
    return nearest_rank(walls, 90) if len(walls) >= 20 else None
