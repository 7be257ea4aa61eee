"""The busy-interval union, the idle gaps and the breakdown."""

import pytest

from benchmark import trace
from benchmark.trace import DeviceEvent, HostRange


def ev(name, dev, a, b):
    return DeviceEvent(name, dev, float(a), float(b))


def test_union_merges_overlaps_and_nesting():
    total, merged = trace.union([(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)])
    assert total == 26
    assert merged == [(0, 15), (20, 31)]


def test_busy_is_the_union_per_card_and_names_sum():
    events = [ev("k1", 0, 0, 10), ev("k2", 0, 5, 15), ev("k1", 1, 0, 4), ev("copy", 0, 40, 50)]
    busy, by_name = trace.busy_intervals(events, 0)
    assert busy == 25
    assert by_name == {"k1": 10, "k2": 10, "copy": 10}
    assert trace.busy_intervals(events, 1)[0] == 4
    assert trace.busy_intervals(events)[0] == 25  # every card's spans in one union


def test_idle_gaps_and_their_names():
    events = [ev("k", 0, 10, 20), ev("k", 0, 50, 60)]
    gaps = trace.idle_gaps(events, 0, (0, 100))
    assert gaps == [(0, 10), (20, 50), (60, 100)]
    ranges = [HostRange("dispatch", 15, 45), HostRange("decode_wait", 60, 75),
              HostRange("benchmark.clip", 0, 100)]
    assert trace.name_gap((20, 50), ranges) == "dispatch"  # 25 of 30 covered
    assert trace.name_gap((60, 100), ranges) == "host"  # 15 covered, 25 not
    assert trace.name_gap((60, 80), ranges) == "decode_wait"
    assert trace.name_gap((0, 10), ranges) == "host"
    b = trace.breakdown(events, ranges, [0], (0, 100))
    assert b["device_ops"] == [["k", pytest.approx(20e-6)]]
    assert b["idle_gaps"][0] == ["host", pytest.approx(40e-6)]
    assert b["idle_gaps"][1] == ["dispatch", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) == 3


def test_union_length_is_the_unions():
    import random

    rng = random.Random(7)
    for n in (0, 1, 2, 50, 500):
        spans = [(a, a + rng.randrange(0, 40)) for a in (rng.randrange(0, 1000) for _ in range(n))]
        assert trace.union_length(spans) == trace.union(spans)[0]
    epoch_ns = 1_792_304_255_912_171_226  # a profiler timestamp: past float64's exact range
    assert trace.union_length([(epoch_ns, epoch_ns + 1001), (epoch_ns + 1, epoch_ns + 3)]) == 1001


def test_device_ms_per_pair_sums_each_cards_union():
    spans = {(0, "kernel"): [(0, 250e6), (100e6, 300e6)], (0, "copy"): [(400e6, 500e6)],
             (1, "kernel"): [(0, 100e6)]}
    assert trace.device_ms_per_pair(spans, [0], 100) == pytest.approx(400 / 100)
    assert trace.device_ms_per_pair(spans, [0], 100, ("kernel",)) == pytest.approx(300 / 100)
    assert trace.device_ms_per_pair(spans, [0, 1], 100) == pytest.approx(500 / 100)
    assert trace.device_ms_per_pair(spans, [2], 100) is None  # nothing ran there
    assert trace.device_ms_per_pair(spans, [0], 0) is None


def test_kind_by_name():
    assert trace.kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert trace.kind("Memset (Device)") == "fill"
    assert trace.kind("void (anonymous namespace)::cost_volume_mse_block_kernel<16>(...)") == "kernel"
