"""#2's bound at the 720p B 24 shapes, as PERF.md's kernel table has it."""

from benchmark import roofline


def test_mse_block_bound_at_720p_b24():
    (l0, l1, l2) = roofline.pyramid_shapes(720, 1280, 3)
    assert (l0, l1, l2) == ((180, 320), (360, 640), (720, 1280))
    ms2, by2 = roofline.volume_bound_ms("cost_volume_mse_block", 24, 720, 1280, 16, 32)
    ms1, by1 = roofline.volume_bound_ms("cost_volume_mse_block", 24, 360, 640, 16, 32)
    assert (by1, by2) == ("bytes", "bytes")
    assert round(ms2, 4) == 0.4500
    assert round(ms1, 4) == 0.1103


def test_volume_work_counts_each_byte_once():
    prev, curr = roofline.volume_inputs(2, 40, 50, 8, 3)
    assert prev == (2, 40, 48) and curr == (2, 46, 54)
    nbytes, ops, kind = roofline.volume_work("cost_volume_mse_block", prev, curr, 8, 7)
    outputs = 2 * 5 * 6 * 49
    assert nbytes == 2 * 40 * 48 + 2 * 46 * 54 + 4 * outputs
    assert ops == 2 * outputs * 64 and kind == "int8 tensor"
    assert roofline.volume_work("cost_volume_rowoffset", prev, curr, 8, 7)[2] == "int32"


def test_odd_pyramid_sizes_round_up():
    assert roofline.pyramid_shapes(241, 321, 3) == [(61, 81), (121, 161), (241, 321)]
