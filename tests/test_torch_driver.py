"""The port's results driver and command line against the JAX package's.

`gme_tpu_torch.pipeline.results.process_video(device="cpu")` and
`python -m gme_tpu_torch.cli` on small synthetic y4m clips: the same PSNR
records (to 1e-4 dB: an f32 mean over the frame), pixel-equal PNG streams
and the same summary keys as the JAX driver run with
`search_impl="volume"` (JAX's "auto" on the CPU is the gather engine);
then the driver's own contracts (resume, frame distance, shards, the
image-before-record fence, the writer thread's errors, the adaptive
dispatch, and what it refuses).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gme_tpu.cli import main as jax_cli
from gme_tpu.config import GMEConfig as JaxGMEConfig
from gme_tpu.config import PipelineConfig as JaxPipelineConfig
from gme_tpu.models.gme import gme_pipeline_batch_adaptive as jax_adaptive
from gme_tpu.pipeline.results import process_video as jax_process_video
from gme_tpu_torch.cli import main as torch_cli
from gme_tpu_torch.config import GMEConfig, MeshConfig, PipelineConfig
from gme_tpu_torch.io import writers as twriters
from gme_tpu_torch.io.video import write_y4m
from gme_tpu_torch.models.gme import gme_pipeline_batch, gme_pipeline_batch_adaptive
from gme_tpu_torch.pipeline import results as R
from test_torch_ops import PARAM_ATOL

cv2 = pytest.importorskip("cv2")

STREAMS = ("frames", "compensated", "curr_prev_diff", "curr_comp_diff", "model_motion_field")
VOLUME = JaxGMEConfig(search_impl="volume")


def _make_clip(tmp_path, rng, n=6, H=64, W=80, name="pan_synth"):
    """tests/test_pipeline.py's clip: random texture panned (2, 3) px per
    frame, as y4m."""
    base = rng.randint(0, 256, (H * 2, W * 2), np.uint8)
    frames = [base[i * 2: i * 2 + H, i * 3: i * 3 + W].copy() for i in range(n)]
    path = str(tmp_path / f"{name}.y4m")
    write_y4m(path, frames)
    return path


def _smooth(rng, H, W):
    low = rng.randint(0, 256, (H // 4 + 1, W // 4 + 1)).astype(np.float32)
    img = np.kron(low, np.ones((4, 4), np.float32))[:H, :W]
    for _ in range(2):
        img = (np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 1) + 4 * img) / 8.0
    return img.astype(np.uint8)


def _alternating_pan(H=128, W=160, n=7, seed=0):
    """A smooth texture panned alternately (2, 3) and (10, 14) px per frame:
    under the fast radii some pairs' walks reach the volume ring and some
    do not."""
    steps = [(2, 3), (10, 14)] * ((n - 1) // 2) + [(2, 3)] * ((n - 1) % 2)
    pos = np.cumsum([(0, 0)] + steps, 0)
    last = pos[-1]
    base = _smooth(np.random.RandomState(seed), H + last[0], W + last[1])
    return np.stack([base[last[0] - p[0]: last[0] - p[0] + H, last[1] - p[1]: last[1] - p[1] + W]
                     for p in pos])


def _records(out_root, video="pan_synth"):
    with open(os.path.join(out_root, video, "psnr_records.json")) as f:
        return json.load(f)


def _assert_same_outputs(torch_root, jax_root, video="pan_synth"):
    got, want = _records(torch_root, video), _records(jax_root, video)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    for stream in STREAMS:
        names = sorted(os.listdir(os.path.join(jax_root, video, stream)))
        assert names == sorted(os.listdir(os.path.join(torch_root, video, stream))), stream
        for name in names:
            a = cv2.imread(os.path.join(torch_root, video, stream, name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(jax_root, video, stream, name), cv2.IMREAD_UNCHANGED)
            assert a is not None and np.array_equal(a, b), (stream, name)


def _port_cfg(jax_cfg):
    return PipelineConfig.from_dict(dataclasses.asdict(jax_cfg))


def test_process_video_equals_jax(tmp_path, rng):
    clip = _make_clip(tmp_path, rng)
    jcfg = JaxPipelineConfig(batch_size=2, gme=VOLUME)
    want = jax_process_video(clip, str(tmp_path / "jax"), jcfg)
    got = R.process_video(clip, str(tmp_path / "port"), _port_cfg(jcfg), device="cpu")
    # the JAX driver's keys, and the port's counters (no `device` on the CPU)
    assert sorted(got) == sorted(list(want) + ["counters"])
    with open(tmp_path / "port" / "pan_synth" / "summary.json") as f:
        assert sorted(json.load(f)) == sorted(list(want) + ["counters"])
    for k in ("video", "frame_shape", "pairs_processed", "frame_distance", "volume_edge_hits"):
        assert got[k] == want[k], k
    assert got["pairs_processed"] == 5 and got["psnr"]["count"] == 5
    _assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    rows = R.summarize_results(str(tmp_path / "port"))
    assert rows and rows[0]["video"] == "pan_synth" and rows[0]["count"] == 5


def test_frame_distance_equals_jax(tmp_path, rng):
    clip = _make_clip(tmp_path, rng, n=8)
    jcfg = JaxPipelineConfig(frame_distance=2, batch_size=4, gme=VOLUME, write_images=False)
    jax_process_video(clip, str(tmp_path / "jax"), jcfg)
    got = R.process_video(clip, str(tmp_path / "port"), _port_cfg(jcfg), device="cpu")
    assert got["pairs_processed"] == 6
    want = _records(str(tmp_path / "jax"))
    assert sorted(_records(str(tmp_path / "port"))) == sorted(want) == [str(i) for i in range(2, 8)]
    for k, v in _records(str(tmp_path / "port")).items():
        assert abs(v - want[k]) <= 1e-4, k
    assert os.listdir(tmp_path / "port" / "pan_synth" / "frames") == []  # images off


def test_process_video_resume_skips_done(tmp_path, rng):
    clip = _make_clip(tmp_path, rng)
    out_root = str(tmp_path / "results")
    cfg = PipelineConfig(batch_size=2)
    first = R.process_video(clip, out_root, cfg, max_pairs=2, device="cpu")
    assert first["pairs_processed"] == 2 and sorted(_records(out_root)) == ["1", "2"]
    summary = R.process_video(clip, out_root, cfg.replace(resume=True), device="cpu")
    assert summary["pairs_processed"] == 3  # pairs 3-5 only
    assert sorted(_records(out_root)) == ["1", "2", "3", "4", "5"]
    assert summary["psnr"]["count"] == 5


def test_shards_split_the_gops(tmp_path, rng):
    """GOP g of gop_size pairs belongs to shard g % num_shards; the shards'
    records together are the whole video's."""
    clip = _make_clip(tmp_path, rng, n=8)
    out_root = str(tmp_path / "results")
    cfg = PipelineConfig(batch_size=2, write_images=False)
    whole = R.process_video(clip, str(tmp_path / "whole"), cfg, device="cpu")
    got = {}
    for k in range(2):
        s = R.process_video(clip, out_root, cfg, shard=(k, 2), gop_size=2, device="cpu")
        assert s["shard"] == {"id": k, "num_shards": 2, "gop_size": 2}
        with open(os.path.join(out_root, "pan_synth", f"psnr_records.rank{k}.json")) as f:
            rec = json.load(f)
        assert os.path.exists(os.path.join(out_root, "pan_synth", f"summary.rank{k}.json"))
        assert sorted(map(int, rec)) == [i for i in range(1, 8) if ((i - 1) // 2) % 2 == k]
        got.update(rec)
    assert got == _records(str(tmp_path / "whole")) and whole["pairs_processed"] == 7


class _FakeAsyncWriter:
    """Holds submissions until drain(), so a missing image-before-record
    fence leaves recorded pairs whose images are only in the queue."""

    def __init__(self, workers=2):
        self.workers = workers
        self.queue = []

    def submit(self, path, img):
        self.queue.append((path, np.array(img)))

    def drain(self):
        for path, img in self.queue:
            twriters.write_png(path, img)
        self.queue.clear()


def test_images_fenced_before_record(tmp_path, rng, monkeypatch):
    """At every records flush the image streams of every recorded pair are
    on disk: `--resume` trusts the ledger."""
    clip = _make_clip(tmp_path, rng)
    fake = _FakeAsyncWriter()
    monkeypatch.setattr(R, "_get_writer", lambda workers=2: fake)
    orig_flush = twriters.PSNRRecords.flush
    seen_flushes = []

    def checked_flush(self):
        for idx in self.records:
            for stream, name in (("compensated", int(idx) - 5), ("frames", int(idx) - 5),
                                 ("curr_prev_diff", int(idx)), ("curr_comp_diff", int(idx)),
                                 ("model_motion_field", int(idx))):
                p = os.path.join(os.path.dirname(self.path), stream, f"{name}.png")
                assert os.path.exists(p), f"record {idx} flushed before its {stream} image hit disk"
        seen_flushes.append(len(self.records))
        return orig_flush(self)

    monkeypatch.setattr(twriters.PSNRRecords, "flush", checked_flush)
    s = R.process_video(clip, str(tmp_path / "results_fence"), PipelineConfig(batch_size=2),
                        device="cpu")
    assert seen_flushes == [2, 4, 5]
    assert s["counters"]["needles_pooled"] == 5 and s["counters"]["png_workers"] == 2


def _stream_bytes(root, video="pan_synth"):
    return {(stream, name): open(os.path.join(root, video, stream, name), "rb").read()
            for stream in STREAMS
            for name in sorted(os.listdir(os.path.join(root, video, stream)))}


def test_native_pool_writes_the_files_of_synchronous_writes(tmp_path, rng, monkeypatch):
    """With the native pool (the needle diagrams' BGR PNGs included) every
    file of the five streams is byte-equal to the writer thread's own
    writes; the counters say how many needles the pool took and its size."""
    from gme_tpu_torch.native import loader

    if not loader.available():
        pytest.skip(f"native runtime not built here: {loader.build_error()}")
    clip = _make_clip(tmp_path, rng)
    cfg = PipelineConfig(batch_size=2)
    pooled = R.process_video(clip, str(tmp_path / "pool"), cfg, device="cpu")
    assert pooled["counters"]["needles_pooled"] == pooled["pairs_processed"] == 5
    assert pooled["counters"]["png_workers"] == loader.AsyncPNGWriter().workers >= 2
    monkeypatch.setattr(R, "_get_writer", lambda: None)
    synchronous = R.process_video(clip, str(tmp_path / "sync"), cfg, device="cpu")
    assert synchronous["counters"]["needles_pooled"] == 0
    assert synchronous["counters"]["png_workers"] == 0
    got, want = _stream_bytes(str(tmp_path / "pool")), _stream_bytes(str(tmp_path / "sync"))
    assert len(want) == 5 * 5 and got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("cores,workers", [(1, 2), (2, 2), (3, 3), (8, 8), (16, 16)])
def test_pool_size_follows_the_affinity(tmp_path, rng, monkeypatch, cores, workers):
    """The pool takes as many workers as the process may run on cores, and
    never fewer than 2; a call without images starts no pool."""
    from gme_tpu_torch.native import loader

    asked = []

    def writer(n):
        asked.append(n)
        return _FakeAsyncWriter(n)

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(100, 100 + cores)))
    monkeypatch.setattr(loader, "available", lambda: True)
    monkeypatch.setattr(loader, "AsyncPNGWriter", writer)
    clip = _make_clip(tmp_path, rng)
    s = R.process_video(clip, str(tmp_path / "img"), PipelineConfig(batch_size=2), device="cpu")
    assert asked == [workers] and s["counters"]["png_workers"] == workers
    s = R.process_video(clip, str(tmp_path / "noimg"),
                        PipelineConfig(batch_size=2, write_images=False), device="cpu")
    assert asked == [workers]
    assert s["counters"]["png_workers"] == s["counters"]["needles_pooled"] == 0


class _PathsWriter(_FakeAsyncWriter):
    """`_FakeAsyncWriter` that keeps the path of every submission."""

    def __init__(self):
        super().__init__()
        self.paths = []

    def submit(self, path, img):
        self.paths.append(path)
        super().submit(path, img)


def test_every_needle_goes_through_the_pool(tmp_path, rng, monkeypatch):
    """With a pool, all five streams, the needle diagrams' BGR PNGs
    included, go to it and none is written on the writer thread; without
    one, all are written there.  `needles_pooled` counts the needles the
    pool took."""
    clip = _make_clip(tmp_path, rng)
    synchronous = []
    real = R.write_png
    monkeypatch.setattr(R, "write_png", lambda path, img: (synchronous.append(path),
                                                           real(path, img)))
    pool = _PathsWriter()
    monkeypatch.setattr(R, "_get_writer", lambda: pool)
    s = R.process_video(clip, str(tmp_path / "pool"), PipelineConfig(batch_size=2), device="cpu")
    needles = [p for p in pool.paths if p.split(os.sep)[-2] == "model_motion_field"]
    assert len(pool.paths) == 5 * 5 and len(needles) == 5 and synchronous == []
    assert s["counters"]["needles_pooled"] == 5
    monkeypatch.setattr(R, "_get_writer", lambda: None)
    s = R.process_video(clip, str(tmp_path / "sync"), PipelineConfig(batch_size=2), device="cpu")
    assert len(synchronous) == 5 * 5 and s["counters"]["needles_pooled"] == 0
    assert sum(p.split(os.sep)[-2] == "model_motion_field" for p in synchronous) == 5


def test_streaming_decode_stages(tmp_path, rng):
    clip = _make_clip(tmp_path, rng)
    s = R.process_video(clip, str(tmp_path / "r_stream"), PipelineConfig(batch_size=2), device="cpu")
    for stage in ("decode", "decode_wait", "dispatch", "device_get", "write_outputs"):
        assert stage in s["stages"], stage
    assert s["stages"]["dispatch"]["count"] == 3 and s["pairs_processed"] == 5


def test_writer_error_fails_the_run(tmp_path, rng, monkeypatch):
    """An exception in the writer thread re-raises in process_video; the
    ledger keeps only the batches written before it."""
    clip = _make_clip(tmp_path, rng)
    orig = R._write_pair_outputs

    def failing(save_path, idx, *args, **kwargs):
        if idx == 3:
            raise OSError("disk full")
        return orig(save_path, idx, *args, **kwargs)

    monkeypatch.setattr(R, "_write_pair_outputs", failing)
    out_root = str(tmp_path / "results")
    with pytest.raises(OSError, match="disk full"):
        R.process_video(clip, out_root, PipelineConfig(batch_size=2), device="cpu")
    assert sorted(_records(out_root)) == ["1", "2"]


def test_process_video_adaptive_matches_default(tmp_path):
    """The adaptive dispatch gives the default run's records on a clip with
    both escaping and non-escaping pairs under the fast radii."""
    frames = _alternating_pan()
    hits = gme_pipeline_batch(torch.from_numpy(frames[:-1]), torch.from_numpy(frames[1:]),
                              GMEConfig().fast())["volume_edge_hits"]
    assert (hits > 0).any() and (hits == 0).any(), hits
    clip = str(tmp_path / "alt.y4m")
    write_y4m(clip, list(frames))
    cfg = PipelineConfig(batch_size=3, write_images=False)
    a = R.process_video(clip, str(tmp_path / "default"), cfg, device="cpu")
    b = R.process_video(clip, str(tmp_path / "adaptive"), cfg.replace(adaptive=True), device="cpu")
    assert a["pairs_processed"] == b["pairs_processed"] == 6
    assert a["volume_edge_hits"] == b["volume_edge_hits"]
    assert _records(str(tmp_path / "default"), "alt") == _records(str(tmp_path / "adaptive"), "alt")


@pytest.mark.parametrize("pairs,escapes", [(slice(0, 6), True), (slice(0, 2), False)])
def test_pipeline_batch_adaptive_equals_jax(pairs, escapes):
    """A batch with escaping pairs (merged per pair) and a batch without
    (the fast tier alone), against JAX's adaptive dispatch."""
    frames = _alternating_pan()[:, :64, :96]
    prev, curr = frames[:-1][pairs], frames[1:][pairs]
    fast_hits = gme_pipeline_batch(torch.from_numpy(prev), torch.from_numpy(curr),
                                   GMEConfig().fast())["volume_edge_hits"]
    assert bool((fast_hits > 0).any()) == escapes and bool((fast_hits == 0).any())
    want = jax_adaptive(jnp.asarray(prev), jnp.asarray(curr), VOLUME)
    got = gme_pipeline_batch_adaptive(torch.from_numpy(prev), torch.from_numpy(curr), GMEConfig())
    default = gme_pipeline_batch(torch.from_numpy(prev), torch.from_numpy(curr), GMEConfig())
    assert set(got) == set(want)
    for k in want:
        if k in ("parameters", "psnr"):
            # Parameters: exact on FMA hosts (PARAM_ATOL); PSNR is an f32 mean
            # over more than 2**24, 1e-4 dB (ROADMAP C6).
            atol = PARAM_ATOL if k == "parameters" else 1e-4
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert torch.equal(got[k], default[k]) or k == "volume_edge_hits", k


def test_driver_refuses(tmp_path, rng, monkeypatch):
    """What the driver still refuses, before it writes a file: adaptive with
    a mesh (the JAX driver ignores the flag there), a mesh larger than its
    device slots (never folded silently), a batch the data axis does not
    divide, and device="cuda" without CUDA."""
    clip = _make_clip(tmp_path, rng)
    out = str(tmp_path / "r")
    mesh = PipelineConfig(mesh=MeshConfig(data=2))
    with pytest.raises(ValueError, match="adaptive"):
        R.process_video(clip, out, mesh.replace(adaptive=True), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        R.process_video(clip, out, mesh, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="must divide by mesh data=2"):
        R.process_video(clip, out, mesh.replace(batch_size=3), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.process_video(clip, out)
    with pytest.raises(ValueError, match="unsupported device"):
        R.process_video(clip, out, device="meta")
    assert not os.path.exists(out)  # refused before any file was written


def test_cli_results_bbme_stats_equal_jax(tmp_path, rng, capsys):
    clip = _make_clip(tmp_path, rng)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    common = ["-v", clip, "--batch-size", "2", "--search-impl", "volume"]
    jax_cli(["results", *common, "-o", jout, "--platform", "cpu"])
    jax_printed = json.loads(capsys.readouterr().out)
    torch_cli(["results", *common, "-o", tout, "--platform", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert sorted(printed) == sorted(list(jax_printed) + ["counters"])
    assert printed["pairs_processed"] == 5
    _assert_same_outputs(tout, jout)

    jax_cli(["stats", jout])
    want = capsys.readouterr().out
    torch_cli(["stats", tout])
    assert capsys.readouterr().out == want and want.startswith("video pan_synth")

    for sp in ("1", "3"):
        jax_cli(["bbme", "-p", clip, "-fi", "4", "-sp", sp, "-o", jout])
        torch_cli(["bbme", "-p", clip, "-fi", "4", "-sp", sp, "-o", tout, "--platform", "cpu"])
        assert capsys.readouterr().out.count("wrote needle diagrams") == 2
        for name in (f"{sp}-res.png", f"{sp}h-res.png"):
            a = cv2.imread(os.path.join(tout, "images", name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(jout, "images", name), cv2.IMREAD_UNCHANGED)
            assert a is not None and np.array_equal(a, b), name


def test_cli_refuses(tmp_path, rng, monkeypatch):
    """What the command line still refuses: adaptive with a mesh, an
    unknown mesh axis, `--platform tpu`, a mesh larger than the visible
    cards, and every command on the card without CUDA."""
    clip = _make_clip(tmp_path, rng)
    out = str(tmp_path / "r")
    with pytest.raises(ValueError, match="adaptive"):
        torch_cli(["results", "-v", clip, "-o", out, "--mesh", "data=2", "--adaptive",
                   "--platform", "cpu"])
    with pytest.raises(SystemExit, match="unknown mesh axis"):
        torch_cli(["results", "-v", clip, "-o", out, "--mesh", "pipe=2", "--platform", "cpu"])
    with pytest.raises(SystemExit):
        torch_cli(["results", "-v", clip, "-o", out, "--platform", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        torch_cli(["results", "-v", clip, "-o", out, "--mesh", "data=1,space=2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["results", "-v", clip, "-o", out], ["bbme", "-p", clip, "-fi", "4", "-o", out],
                 ["direct", "-v", clip, "-fi", "1"],
                 ["results", "-v", clip, "-o", out, "--num-processes", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_cli(argv)


def test_profile_dir_writes_a_trace(tmp_path, rng):
    """`profile_dir` traces the run with torch.profiler and exports
    trace.json, the main thread's stages among its named ranges (the
    profiler records the thread that started it; the writer thread's
    stages are timed in summary.json only)."""
    clip = _make_clip(tmp_path, rng, n=3)
    prof = tmp_path / "prof"
    R.process_video(clip, str(tmp_path / "r"), PipelineConfig(batch_size=2), device="cpu",
                    profile_dir=str(prof))
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"decode_wait", "dispatch"} <= names, names


def test_stage_timer_counts_every_add_across_threads():
    """The driver's main and writer threads share one StageTimer: no add
    is lost under heavy thread switching."""
    import sys
    import threading

    from gme_tpu_torch.utils.profiling import StageTimer

    timers, n_threads, n_adds = StageTimer(), 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [timers.add("write_outputs", 1.0)
                                                    for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    s = timers.summary()["write_outputs"]
    assert s["count"] == n_threads * n_adds and s["total_s"] == float(n_threads * n_adds)
