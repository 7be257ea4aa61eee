"""The window and percentile arithmetic on a fake clip timeline."""

import pytest

from benchmark.window import Window, nearest_rank


def p90(w):
    return nearest_rank([c.seconds for c in w.clips], 90)


def timeline(n, seconds, wall=0.25, stall_every=0, stall=0.25, pairs=206):
    w = Window(10.0, seconds)
    t = 10.0
    for k in range(n):
        d = wall + (stall if stall_every and k % stall_every == 0 else 0.0)
        w.add(t, t + d, pairs)
        t += d
        if w.closed:
            break
    return w


def test_window_closes_at_the_first_clip_past_its_length():
    w = timeline(1000, 25.0)
    assert w.closed
    assert len(w.clips) == 100  # 100 x 0.25 s reaches 25 s
    assert w.length == pytest.approx(25.0)
    assert w.pairs_per_s() == pytest.approx(100 * 206 / 25.0)
    assert p90(w) == pytest.approx(0.25)


def test_a_stall_moves_the_p90_and_the_rate():
    calm, stalled = timeline(1000, 25.0), timeline(1000, 25.0, stall_every=5)
    assert p90(stalled) == pytest.approx(0.5)
    assert stalled.pairs_per_s() < 0.9 * calm.pairs_per_s()


def test_rate_counts_each_clips_start_up():
    # gaps between clips (start-up outside process_video) count in the window
    w = Window(0.0, 1.0)
    w.add(0.1, 0.5, 10)
    w.add(0.6, 1.2, 10)
    assert w.closed and w.length == pytest.approx(1.2)
    assert w.pairs_per_s() == pytest.approx(20 / 1.2)


def test_nearest_rank_percentile():
    walls = [float(k) for k in range(10, 0, -1)]
    assert nearest_rank(walls, 90) == 9.0
    assert nearest_rank(walls, 100) == 10.0
    assert nearest_rank(walls, 50) == 5.0
    assert nearest_rank(walls, 1) == 1.0


def test_a_pause_between_clips_is_left_out():
    # the harness's own work between clips (pruning images) is not the window's
    w = Window(0.0, 1.0)
    w.add(0.0, 0.6, 10)
    w.pause(0.3)
    w.add(0.9, 1.2, 10)
    assert not w.closed and w.length == pytest.approx(0.9)
    w.add(1.2, 1.5, 10)
    assert w.closed and w.pairs_per_s() == pytest.approx(30 / 1.2)
