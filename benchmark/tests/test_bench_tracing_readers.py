"""The readers of the driver's spans, counters and device events in
summary.json: a value on hand-made summaries, None where a key is absent
(a program without them, or the CPU, which records no device events)."""

import pytest

from benchmark import spec

READERS = ("dispatch.stack_ms_per_batch.720", "dispatch.upload_ms_per_batch.720",
           "dispatch.step_ms_per_batch.720", "device.upload_gb_per_s.720",
           "step.device_ms_per_pair.720", "device.idle_decode_share.720",
           "driver.writer_wait_ms_per_batch", "device.idle_writer_share",
           "writer.needle_ms_per_pair", "compiled.capture_s")


def _summary(capture_s=12.5):
    return {
        "pairs_processed": 200,
        "stages": {
            "dispatch": {"total_s": 0.45, "count": 9},
            "dispatch.stack": {"total_s": 0.09, "count": 9},
            "dispatch.upload": {"total_s": 0.18, "count": 9},
            "dispatch.step": {"total_s": 0.0225, "count": 9},
            "writer_wait": {"total_s": 0.54, "count": 9},
            "write_outputs.needle": {"total_s": 0.6, "count": 9},
        },
        "counters": {"slots": 216, "h2d_bytes": 4_000_000_000, "captures": 0,
                     "process_capture_s": capture_s},
        "device": {"upload_s": 0.5, "step_s": 0.11, "copy_out_s": 0.05, "idle_s": 0.4,
                   "idle_by_stage_s": {"decode_wait": 0.1, "startup": 0.02,
                                       "writer_wait": 0.2, "dispatch.stack": 0.08}},
    }


def _ctx(summaries):
    return {"summaries": summaries}


def test_readers_on_summaries():
    ctx = _ctx([_summary(12.0), _summary(12.5)])
    want = {
        "dispatch.stack_ms_per_batch.720": 10.0,
        "dispatch.upload_ms_per_batch.720": 20.0,
        "dispatch.step_ms_per_batch.720": 2.5,
        "device.upload_gb_per_s.720": 8.0,
        "step.device_ms_per_pair.720": 0.55,
        "device.idle_decode_share.720": 0.3,
        "driver.writer_wait_ms_per_batch": 60.0,
        "device.idle_writer_share": 0.5,
        "writer.needle_ms_per_pair": 3.0,
        "compiled.capture_s": 12.5,  # the last clip's
    }
    for name in READERS:
        assert spec.load_reader(name)(ctx) == pytest.approx(want[name]), name


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_their_keys(name):
    """Summaries with only the `dispatch` and `write_outputs` stages (no
    child spans, counters or device events) and a CPU run's (no device
    events): None, never a raise."""
    read = spec.load_reader(name)
    old = {"pairs_processed": 200, "stages": {"dispatch": {"total_s": 0.45, "count": 9},
                                               "write_outputs": {"total_s": 2.0, "count": 9}}}
    assert read(_ctx([old, old])) is None
    assert read(_ctx([])) is None
    cpu = dict(_summary())
    del cpu["device"]
    if name.startswith(("device.", "step.")):
        assert read(_ctx([cpu])) is None
    else:
        assert read(_ctx([cpu])) is not None


def test_shares_of_idle_sum_to_one():
    d = _summary()["device"]
    assert sum(d["idle_by_stage_s"].values()) == pytest.approx(d["idle_s"])
