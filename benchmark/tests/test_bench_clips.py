"""The clip generator: deterministic per seed, and a y4m round trip."""

import numpy as np

from benchmark import clips
from benchmark.tests.tiny import SEED


def test_draw_is_deterministic_per_seed():
    speeds = [[4, 8], [1, 3]]
    a = clips.draw_clips(SEED, speeds)
    assert a == clips.draw_clips(SEED, speeds)
    assert a != clips.draw_clips(SEED + 1, speeds)
    seen = set()
    for seed in range(SEED, SEED + 8):
        drawn = clips.draw_clips(seed, speeds)
        # every seed pans at the same speeds; signs and order vary
        assert sorted([abs(r), abs(c)] for r, c in (d["step"] for d in drawn)) == [[1, 3], [4, 8]]
        assert all(0 <= d["texture_seed"] < 2**32 for d in drawn)
        seen.add(tuple(d["step"] for d in drawn))
    assert len(seen) > 1


def test_pan_is_deterministic_and_pans_by_its_step():
    for step in [(3, 6), (-4, 8), (2, -7), (-1, -1), (0, 0)]:
        f = clips.synthetic_pan(5, 48, 64, step, 7)
        assert np.array_equal(f, clips.synthetic_pan(5, 48, 64, step, 7))
        assert not np.array_equal(f, clips.synthetic_pan(5, 48, 64, step, 8))
        r, c = step
        # frame i+1 is frame i moved by +step (where both are defined)
        a = f[0][max(-r, 0):48 - max(r, 0), max(-c, 0):64 - max(c, 0)]
        b = f[1][max(r, 0):48 - max(-r, 0), max(c, 0):64 - max(-c, 0)]
        assert np.array_equal(a, b)


def test_y4m_round_trip(tmp_path):
    f = clips.synthetic_pan(6, 48, 66, (2, -3), 11)
    path = str(tmp_path / "c.y4m")
    n = clips.write_y4m(path, f)
    assert n == len(clips.Y4M_HEADER.format(w=66, h=48)) + 6 * (6 + 48 * 66 + 2 * 24 * 33)
    assert np.array_equal(clips.read_y4m(path), f)


def test_port_decodes_what_the_writer_writes(tmp_path):
    from gme_tpu_torch.io.video import iter_video_frames

    f = clips.synthetic_pan(4, 32, 48, (1, 2), 3)
    path = str(tmp_path / "c.y4m")
    clips.write_y4m(path, f)
    assert np.array_equal(np.stack(list(iter_video_frames(path))), f)
