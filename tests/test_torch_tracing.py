"""The driver's tracing on the CPU: `StageTimer`'s spans, the stages and
counters in summary.json, the `--profile-dir` trace of every thread, and
the sharing out of the device's idle gaps among the main thread's spans
(`utils/profiling.attribute_idle`).  The device events' readings need a
card: `tests/test_torch_cuda.py::test_driver_device_events_and_captures`.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from gme_tpu_torch.config import PipelineConfig
from gme_tpu_torch.io import writers
from gme_tpu_torch.io.video import FramePrefetcher, write_y4m
from gme_tpu_torch.pipeline import results as R
from gme_tpu_torch.utils.compiled import capture_stats
from gme_tpu_torch.utils.profiling import Span, StageTimer, attribute_idle

MAIN = ("startup", "decode_wait", "dispatch", "dispatch.stack", "dispatch.upload",
        "dispatch.step", "dispatch.copy_out", "writer_wait")
WRITER = ("device_get", "write_outputs", "write_outputs.drain", "write_outputs.records")
PER_PAIR = ("write_outputs.diff", "write_outputs.png", "write_outputs.needle")
CHILDREN = {"dispatch": ("stack", "upload", "step", "copy_out"),
            "write_outputs": ("diff", "png", "needle", "drain", "records")}


class _LoggedWriter:
    """The pool's interface: writes at once, logging each path."""

    workers = 2

    def __init__(self, log):
        self.log = log

    def submit(self, path, img):
        self.log.append(path)
        writers.write_png(path, img)

    def drain(self):
        pass


class _QueueWriter:
    """The pool's interface: holds submissions until drain()."""

    workers = 2

    def __init__(self):
        self.queue = []

    def submit(self, path, img):
        self.queue.append((path, np.array(img)))

    def drain(self):
        for path, img in self.queue:
            writers.write_png(path, img)
        self.queue.clear()


def _clip(tmp_path, n=6, H=48, W=64):
    rng = np.random.RandomState(7)
    base = rng.randint(0, 256, (H * 2, W * 2), np.uint8)
    path = str(tmp_path / "pan.y4m")
    write_y4m(path, [base[i * 2: i * 2 + H, i * 3: i * 3 + W].copy() for i in range(n)])
    return path


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """process_video on the CPU with images, the pool faked; returns
    (summary, the call's StageTimer, the main thread's id)."""
    timers = []

    class Kept(StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    monkeypatch.setattr(R, "StageTimer", Kept)
    monkeypatch.setattr(R, "_get_writer", lambda workers=2: _QueueWriter())

    def run(batch_size=2, n=6, **kwargs):
        timers.clear()
        s = R.process_video(_clip(tmp_path, n), str(tmp_path / f"out{batch_size}"),
                            PipelineConfig(batch_size=batch_size), device="cpu", **kwargs)
        return s, timers[0], threading.get_ident()

    return run


def test_summary_holds_every_stage_and_counter(traced):
    s, _, _ = traced()
    for name in MAIN + WRITER + PER_PAIR + ("decode",):
        assert name in s["stages"], name
        assert s["stages"][name]["total_s"] >= 0
    assert s["stages"]["startup"]["count"] == 1
    assert s["stages"]["writer_wait"]["count"] == 3  # one a batch: two in the loop, the last
    for name in ("dispatch.stack", "dispatch.upload", "dispatch.step", "dispatch.copy_out",
                 "write_outputs.diff", "write_outputs.png", "write_outputs.needle",
                 "write_outputs.drain", "write_outputs.records"):
        assert s["stages"][name]["count"] == 3, name  # one a batch, not a pair
    assert set(s["counters"]) == {"slots", "h2d_bytes", "captures", "process_capture_s",
                                  "png_workers", "needles_pooled"}
    assert s["counters"]["png_workers"] == 2
    assert s["counters"]["needles_pooled"] == s["pairs_processed"] == 5
    assert "device" not in s  # CUDA events only


def test_children_sum_to_no_more_than_their_parent(traced):
    s, timers, _ = traced(batch_size=4, n=10)
    st = s["stages"]
    for parent, kids in CHILDREN.items():
        assert sum(st[f"{parent}.{k}"]["total_s"] for k in kids) <= st[parent]["total_s"]
    # Each child span lies inside a span of its parent's name on its thread.
    kids_ns = {}
    for sp in timers.spans:
        if "." not in sp.name:
            continue
        parent = sp.name.rsplit(".", 1)[0]
        host = [p for p in timers.spans if p.name == parent and p.thread == sp.thread
                and p.start_ns <= sp.start_ns <= sp.end_ns <= p.end_ns]
        assert len(host) == 1, sp
        key = (host[0].start_ns, parent)
        kids_ns[key] = kids_ns.get(key, 0) + sp.end_ns - sp.start_ns
    assert {p for _, p in kids_ns} == {"dispatch", "write_outputs"}
    spans = {(p.start_ns, p.name): p for p in timers.spans}
    for key, ns in kids_ns.items():
        assert ns <= spans[key].end_ns - spans[key].start_ns


def test_writer_keeps_the_per_pair_order(traced, monkeypatch):
    """The writer writes a pair's five images before the next pair's, in
    the reference's order; its per-pair work is timed with no span."""
    written = []
    real = R.write_png
    monkeypatch.setattr(R, "write_png", lambda path, img: (written.append(path), real(path, img)))
    monkeypatch.setattr(R, "_get_writer", lambda workers=2: _LoggedWriter(written))
    s, timers, main = traced(batch_size=2, n=6)
    streams = ("frames", "compensated", "curr_prev_diff", "curr_comp_diff",
               "model_motion_field")
    assert [p.split(os.sep)[-2] for p in written] == list(streams) * 5
    names = [os.path.basename(p) for p in written]
    assert names[:5] == ["-4.png", "-4.png", "1.png", "1.png", "1.png"]
    assert not {sp.name for sp in timers.spans} & set(PER_PAIR)
    assert sum(s["stages"][n]["total_s"] for n in PER_PAIR) <= s["stages"]["write_outputs"]["total_s"]


@pytest.mark.parametrize("batch_size,slots", [(2, 6), (5, 5), (4, 8), (8, 8)])
def test_slots_count_the_padding(traced, batch_size, slots):
    """Five pairs: the slots dispatched, padding included, beside the real
    pairs; nothing uploaded to a card on the CPU."""
    s, _, _ = traced(batch_size=batch_size)
    assert s["pairs_processed"] == 5
    assert s["counters"]["slots"] == slots
    assert s["counters"]["h2d_bytes"] == 0


def test_no_capture_on_the_cpu(traced):
    before = capture_stats()
    s, _, _ = traced()
    assert s["counters"]["captures"] == 0
    assert s["counters"]["process_capture_s"] == before["seconds"] == capture_stats()["seconds"]


def test_profile_dir_trace_holds_every_thread(traced, tmp_path):
    """The operator's trace holds the writer thread's ranges, on a thread
    other than the main thread's `dispatch`."""
    prof = tmp_path / "prof"
    traced(profile_dir=str(prof))
    with open(prof / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    tids = {}
    for e in events:
        tids.setdefault(e["name"], set()).add(e["tid"])
    for name in ("dispatch", "dispatch.step", "write_outputs", "write_outputs.records",
                 "device_get", "writer_wait"):
        assert name in tids, name
    assert tids["write_outputs"].isdisjoint(tids["dispatch"])
    assert tids["device_get"] == tids["write_outputs"]
    assert tids["writer_wait"] == tids["dispatch"]


def test_decoder_blocked_stage(tmp_path):
    """The decoder's waits on `max_ahead` are `decode.blocked` spans on its
    own thread."""
    timers = StageTimer()
    pf = FramePrefetcher(_clip(tmp_path), max_ahead=2, timers=timers)
    try:
        assert pf.frame(1) is not None
        time.sleep(0.05)  # the decoder waits, two frames ahead
        for i in range(6):
            assert pf.frame(i) is not None
            pf.release_below(i + 1)
        assert pf.count() == 6
    finally:
        pf.close()
    blocked = [sp for sp in timers.spans if sp.name == "decode.blocked"]
    assert blocked and all(sp.thread != threading.get_ident() for sp in blocked)
    assert timers.summary()["decode.blocked"]["total_s"] >= 0.04


def _span(name, start, end):
    return Span(name, 1, start, end)


SPANS = [_span("startup", 0, 100), _span("decode_wait", 10, 30),
         _span("dispatch", 100, 150), _span("dispatch.stack", 100, 120),
         _span("writer_wait", 150, 200), _span("decode_wait", 205, 208)]


@pytest.mark.parametrize("gaps,want", [
    ([(0, 110)], {"startup": 80, "decode_wait": 20, "dispatch.stack": 10}),
    ([(140, 210)], {"dispatch": 10, "writer_wait": 50, "decode_wait": 3, "host": 7}),
    ([(0, 110), (140, 210)], {"startup": 80, "decode_wait": 23, "dispatch.stack": 10,
                              "dispatch": 10, "writer_wait": 50, "host": 7}),
    ([(300, 400)], {"host": 100}),
    ([(120, 121), (50, 50)], {"dispatch": 1}),
])
def test_attribute_idle(gaps, want):
    got = attribute_idle(SPANS, gaps)
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    total = sum(b - a for a, b in gaps) / 1e9
    assert sum(v / total for v in got.values()) == pytest.approx(1, abs=1e-12)


def test_device_summary_gaps():
    """A call's first batch is idle from the call's entry; a later batch's
    gap ends where the main thread recorded its first event."""
    rows = [(100, None, 0.5, 1.0, 0.25), (300, 50, 0.5, 2.0, 0.25)]
    d = R._device_summary(rows, 0, SPANS)
    assert (d["upload_s"], d["step_s"], d["copy_out_s"]) == (1.0, 3.0, 0.5)
    assert d["idle_s"] == pytest.approx(150 / 1e9)
    assert d["idle_by_stage_s"] == pytest.approx(
        {"startup": 80e-9, "decode_wait": 20e-9, "host": 50e-9})


def test_attribute_idle_on_an_hour_long_clip():
    """The idle pass over the spans of an hour of 30 fps video at batch 8
    (a `decode_wait` a frame, eight spans a batch) and a gap a batch costs
    seconds, not the minutes a pass over every span for every gap took."""
    frames, bsz = 108_000, 8
    spans, gaps, t = [], [], 0
    for b in range(frames // bsz):
        for _ in range(bsz):
            spans.append(_span("decode_wait", t, t + 50_000))
            t += 60_000
        d = t
        kids = [("dispatch.stack", 3_000_000), ("dispatch.upload", 900_000),
                ("dispatch.step", 200_000), ("dispatch.copy_out", 100_000)]
        for name, ns in kids:
            spans.append(_span(name, t, t + ns))
            t += ns
        spans.append(_span("dispatch", d, t))
        spans.append(_span("writer_wait", t, t + 60_000_000))
        gaps.append((t - 2_000_000, t + 61_000_000))
        t += 62_000_000
    t0 = time.perf_counter()
    got = attribute_idle(spans, gaps)
    took = time.perf_counter() - t0
    assert took < 10, took
    n = len(gaps)
    assert got["writer_wait"] == pytest.approx(n * 0.060)
    assert got["dispatch.stack"] == pytest.approx(n * 0.0008)
    assert got["host"] == pytest.approx(n * 0.001)
    assert sum(got.values()) == pytest.approx(n * 0.063)


def test_profile_dir_without_the_all_threads_option(traced, tmp_path, monkeypatch):
    """Where the installed torch lacks `profile_all_threads`, the trace is
    written all the same, with the main thread's ranges."""
    import torch._C._profiler as P

    def refuses(**kwargs):
        raise TypeError("unexpected keyword argument 'profile_all_threads'")

    monkeypatch.setattr(P, "_ExperimentalConfig", refuses)
    prof = tmp_path / "prof"
    traced(profile_dir=str(prof))
    with open(prof / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert {"dispatch", "writer_wait"} <= names


def test_spans_close_innermost_first():
    timers = StageTimer()
    outer = timers.start("outer")
    inner = timers.start("outer.inner")
    with pytest.raises(RuntimeError, match="out of order"):
        timers.stop(outer)
    timers.stop(inner)
    timers.stop(outer)
    assert [sp.name for sp in timers.spans] == ["outer.inner", "outer"]
    a, b = timers.spans
    assert b.start_ns <= a.start_ns <= a.end_ns <= b.end_ns
