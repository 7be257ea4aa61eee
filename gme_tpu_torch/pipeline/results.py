"""The results driver: `process_video`, the port's main entry point.

Counterpart of `gme_tpu/pipeline/results.py` (reference results.py:14-112):
decode the video on a background thread, run batches of frame pairs
through the per-pair step (GME -> affine field -> compensation -> PSNR) on
one device, and write the reference's outputs:

    <out>/<video>/{frames,compensated,curr_prev_diff,curr_comp_diff,
                   model_motion_field}/*.png
    <out>/<video>/psnr_records.json
    <out>/<video>/summary.json

The files, their names (the reference's `idx-5` naming of the frames and
compensated streams included) and the `resume`, `max_pairs`,
`frame_distance`, `shard` and `gop_size` semantics are the JAX driver's.

Double buffering.  The JAX driver overlaps a batch's host writes with the
next batch's device compute through asynchronous dispatch.  On the card the
port's step is a compiled `gme_pipeline_batch` (a CUDA graph replay that
reads nothing back; the adaptive dispatch reads its certificate once), and
each finished batch is handed to one writer thread.
Its outputs go to the host by a non-blocking copy into pinned memory, and
the writer waits on a CUDA event recorded after the copy, then computes the
diffs and draws the needle diagrams, hands every PNG (gray and BGR) to the
native pool (its workers sized from the cores the process may use), drains
it, and only then flushes the records (the image-before-record fence: the
records are the restart ledger).  A call without images starts no pool.
Meanwhile the main thread runs the next batch's step; at most two batches
are in flight, and an error in the writer re-raises in `process_video`.

Tracing.  Every stage is a `StageTimer` span (`utils/profiling.py`), on
the main thread (`startup` until the first dispatch; `decode_wait`;
`dispatch` and its children `.stack`, `.upload`, `.step`, `.copy_out`;
`writer_wait`), the writer thread (`device_get`; `write_outputs` and its
children `.drain`, `.records`) and the decoder's (`decode.blocked`).  The
writer works pair by pair, so its per-pair work, `write_outputs.diff`,
`.png` and `.needle`, is timed by clock reads and added up a batch, with no
span.  On CUDA each batch records four timing events on the upload
device's stream (before and after the upload, after the step, after the
output copy: the event the writer waits on), outside the step's graph.
The writer reads them, and the device's idle gap since the previous
batch's last event; each gap ends on the host clock where the main thread
recorded the batch's first event, and `attribute_idle` shares it out among
the main thread's spans.
summary.json holds the stages, `counters` and, on CUDA, `device`.

The device is explicit: `device="cuda"` (the default) raises without CUDA;
the CPU runs only when `device="cpu"` is passed.  A mesh other than 1x1
(`cfg.mesh`) runs over the slots `devices`: by default the visible cards
on CUDA, every slot the CPU on the CPU; a list may name one device more
than once (a mesh on one card), and a mesh larger than its slots raises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gme_tpu_torch.config import PipelineConfig
from gme_tpu_torch.io.draw import draw_motion_field
from gme_tpu_torch.io.video import FramePrefetcher
from gme_tpu_torch.io.writers import PSNRRecords, write_png
from gme_tpu_torch.models.gme import gme_pipeline_batch, gme_pipeline_batch_adaptive
from gme_tpu_torch.parallel.mesh import Mesh, default_devices, make_mesh
from gme_tpu_torch.utils.compiled import capture_stats
from gme_tpu_torch.utils.profiling import StageTimer, attribute_idle, maybe_profile

_STREAMS = (
    "frames",
    "compensated",
    "curr_prev_diff",
    "curr_comp_diff",
    "model_motion_field",
)

# Outputs copied to the host.  The diff images are recomputed on the host
# from the decoded frames (the same integer math).
_TRANSFER_KEYS = (
    "parameters",
    "model_motion_field",
    "compensated",
    "psnr",
    "volume_edge_hits",
)


def _prepare_dirs(save_path: str) -> None:
    os.makedirs(save_path, exist_ok=True)
    for s in _STREAMS:
        os.makedirs(os.path.join(save_path, s), exist_ok=True)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def _run_mesh(cfg: PipelineConfig, dev: torch.device, devices=None) -> Optional[Mesh]:
    """The mesh of `cfg.mesh` over the slots `devices` (default: the visible
    cards on CUDA, the CPU in every slot on the CPU), or None for 1x1.
    Raises for adaptive with a mesh (the JAX driver ignores the flag there),
    a batch the data axis does not divide, and too few slots."""
    m = cfg.mesh
    if m.data * m.space == 1:
        return None
    if cfg.adaptive:
        raise ValueError(f"adaptive=True runs on the 1x1 mesh only, not {m.data}x{m.space}")
    if cfg.batch_size % m.data:
        raise ValueError(f"batch_size={cfg.batch_size} must divide by mesh data={m.data}")
    if devices is None:
        devices = default_devices() if dev.type == "cuda" else [dev] * (m.data * m.space)
    return make_mesh(data=m.data, space=m.space, devices=devices)


def _build_step(cfg: PipelineConfig, mesh: Optional[Mesh], H: int, W: int):
    """The batched per-pair step, returning only the outputs the driver
    copies to the host (with `write_images=False`: parameters, PSNR and
    the edge hits).  Without a mesh: `gme_pipeline_batch` (or the adaptive
    dispatch); a Dx1 mesh: data parallel; a DxS mesh: pairs over data and
    frame rows over space (`parallel/spatial.py`, which checks H x W)."""
    keys = (
        _TRANSFER_KEYS
        if cfg.write_images
        else ("parameters", "psnr", "volume_edge_hits")
    )
    if mesh is None:
        # The adaptive dispatch reads its escape certificate on the host
        # once per batch (models.gme.gme_pipeline_batch_adaptive).
        batch_fn = gme_pipeline_batch_adaptive if cfg.adaptive else gme_pipeline_batch

        def base(prev, curr):
            return batch_fn(prev, curr, cfg.gme)
    elif cfg.mesh.space == 1:
        from gme_tpu_torch.parallel.data_parallel import make_sharded_pipeline

        base = make_sharded_pipeline(mesh, cfg.gme)
    else:
        from gme_tpu_torch.parallel.spatial import make_spatial_pipeline

        base = make_spatial_pipeline(mesh, cfg.gme, H, W)

    def step(prev: torch.Tensor, curr: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = base(prev, curr)
        return {k: out[k] for k in keys}

    return step


def _png_workers() -> int:
    """The PNG pool's size: the cores this process may run on (its
    affinity, so a process pinned to part of a host takes its share; GOP
    shards that share a host divide it, `parallel/multihost.py`), and at
    least 2."""
    return max(2, len(os.sched_getaffinity(0)))


def _get_writer():
    """The native asynchronous PNG writer when it builds, else None
    (synchronous writes).  The pool starts at the first call's size and
    keeps it for the process (`AsyncPNGWriter.workers`)."""
    from gme_tpu_torch.native.loader import AsyncPNGWriter, available

    return AsyncPNGWriter(_png_workers()) if available() else None


class _Marks:
    """A batch's timing events on the upload device's current stream:
    before the upload, after it, after the step and after the output copy;
    `host_ns` is the host's clock (`perf_counter_ns`) as the first was
    recorded."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.current_stream(device)
        self.events: List[torch.cuda.Event] = []
        self.record()
        self.host_ns = time.perf_counter_ns()

    def record(self) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        self.events.append(event)

    def read(self, prev: Optional["_Marks"]) -> Tuple[float, float, float, Optional[int]]:
        """(upload, step, copy-out seconds, the idle ns since `prev`'s last
        event, None without one), once the last event has completed."""
        e = self.events
        upload, step, copy = (e[i].elapsed_time(e[i + 1]) / 1e3 for i in range(3))
        gap = round(prev.events[-1].elapsed_time(e[0]) * 1e6) if prev is not None else None
        return upload, step, copy, gap


def _start_copy(out: Dict[str, torch.Tensor], marks: Optional[_Marks]):
    """Start copying a batch's outputs to the host: pinned host tensors
    filled by non-blocking copies, and the CUDA event recorded after them
    that the writer waits on (None on the CPU, where the outputs already
    are on the host): `marks`' fourth where the outputs are on its stream,
    else an untimed event on the outputs' device."""
    dev = next(iter(out.values())).device
    if dev.type != "cuda":
        return out, None
    host = {}
    for k, v in out.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    stream = torch.cuda.current_stream(dev)
    if marks is not None and stream == marks.stream:
        marks.record()
        return host, marks.events[-1]
    event = torch.cuda.Event()
    event.record(stream)
    return host, event


def process_video(
    video_path: str,
    out_root: str = "results",
    cfg: Optional[PipelineConfig] = None,
    profile_dir: Optional[str] = None,
    max_pairs: Optional[int] = None,
    shard: Optional[Tuple[int, int]] = None,
    gop_size: int = 16,
    device="cuda",
    devices=None,
) -> Dict:
    """Run the full pipeline over one video on `device`; returns the
    summary dict (also written to summary.json).

    `shard=(shard_id, num_shards)` selects this process's GOPs: pairs group
    into GOPs of `gop_size`, and GOP g belongs to shard g % num_shards; the
    shard writes psnr_records.rank<k>.json and summary.rank<k>.json.
    `devices` are the slots of `cfg.mesh` (module docstring); the batches
    go to `device` and the step's outputs come back on the first slot.
    """
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    mesh = _run_mesh(cfg, dev, devices)
    fd = cfg.frame_distance
    bsz = cfg.batch_size
    timers = StageTimer()
    main_thread = threading.get_ident()
    captures_before = capture_stats()["count"]

    video_name = os.path.splitext(os.path.basename(video_path))[0]
    save_path = os.path.join(out_root, video_name)
    # The decoder holds at most `max_ahead` frames past the release
    # watermark: two batches in flight + frame_distance + the current peek,
    # with 2x slack.
    max_ahead = 2 * (2 * bsz + fd + 2)
    pf = pool = None
    startup = timers.start("startup")  # until the first dispatch
    entry_ns = startup.start_ns
    try:
        _prepare_dirs(save_path)
        pf = FramePrefetcher(video_path, max_ahead=max_ahead, timers=timers)
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gme-writer")
        with timers.stage("decode_wait"):
            first = pf.frame(0)
        if first is None:
            raise RuntimeError(f"Error reading video file: {video_path}")
        H, W = int(first.shape[0]), int(first.shape[1])
        step = _build_step(cfg, mesh, H, W)

        shard_id, num_shards = shard if shard is not None else (0, 1)
        rec_name = (
            "psnr_records.json" if shard is None
            else f"psnr_records.rank{shard_id}.json"
        )
        records = PSNRRecords(os.path.join(save_path, rec_name))
        done = set(records.records) if cfg.resume else set()
        # A call without images submits nothing: it starts no pool.
        writer = _get_writer() if cfg.write_images else None
        needles_pooled = 0  # needle diagrams handed to the pool

        # Per timed batch: (host ns of its first event, the device's idle
        # ns before it or None for a call's first batch, upload, step and
        # copy-out seconds); appended by the writer thread.
        device_rows: List[Tuple[int, Optional[int], float, float, float]] = []

        def _flush(batch_idx: List[int], host, event, marks, prev_marks) -> int:
            """Writer thread: wait for the batch's copy, read its timing
            events, write its images, then flush its records; returns its
            real pairs' edge hits."""
            nonlocal needles_pooled
            with timers.stage("device_get"):
                if event is not None:
                    event.synchronize()
                out = {k: v.numpy() for k, v in host.items()}
            if marks is not None and len(marks.events) == 4:
                upload, step_s, copy, gap = marks.read(prev_marks)
                device_rows.append((marks.host_ns, gap, upload, step_s, copy))
            # Walks stopped on the volume boundary ring, over the real
            # (not padding) pairs of the batch.
            hits = int(out.pop("volume_edge_hits")[: len(batch_idx)].sum())
            with timers.stage("write_outputs"):
                if cfg.write_images:
                    spent = [0, 0, 0]  # the batch's ns of _PAIR_STAGES
                    for k, idx in enumerate(batch_idx):
                        needles_pooled += _write_pair_outputs(
                            save_path, idx, pf.frame(idx - fd), pf.frame(idx),
                            {key: out[key][k] for key in out}, writer, spent,
                        )
                    for name, ns in zip(_PAIR_STAGES, spent):
                        timers.add(name, ns / 1e9)
                    # Image-before-record fence: every image of these pairs
                    # is on disk before the ledger marks them done.
                    if writer is not None:
                        with timers.stage("write_outputs.drain"):
                            writer.drain()
                with timers.stage("write_outputs.records"):
                    for k, idx in enumerate(batch_idx):
                        records.add(idx, float(out["psnr"][k]))
                    records.flush()
            return hits

        n_slots = h2d_bytes = 0

        def _dispatch(batch_idx: List[int]):
            """Run the step on one batch, padded by repeating its last
            index, and start copying its outputs to the host; returns
            (host tensors, the copy's event, the batch's timing marks)."""
            nonlocal startup, n_slots, h2d_bytes
            if startup is not None:
                timers.stop(startup)
                startup = None
            idx_arr = batch_idx + [batch_idx[-1]] * (bsz - len(batch_idx))
            with timers.stage("dispatch"):
                with timers.stage("dispatch.stack"):
                    prev = torch.from_numpy(np.stack([pf.frame(i - fd) for i in idx_arr]))
                    curr = torch.from_numpy(np.stack([pf.frame(i) for i in idx_arr]))
                # Each event is recorded inside a child span, so that the
                # parent's own time stays the few statements between them.
                with timers.stage("dispatch.upload"):
                    marks = _Marks(dev) if dev.type == "cuda" else None
                    prev, curr = prev.to(dev), curr.to(dev)
                    if marks is not None:
                        marks.record()
                with timers.stage("dispatch.step"):
                    out = step(prev, curr)
                    if marks is not None:
                        marks.record()
                with timers.stage("dispatch.copy_out"):
                    host, event = _start_copy(out, marks)
            n_slots += len(idx_arr)
            if marks is not None:
                h2d_bytes += prev.nbytes + curr.nbytes
            return host, event, marks

        edge_hits_total = 0
        last_marks = None  # the previous batch's, within this call
        pending = None  # (batch indices, the writer's future)

        def _wait_writer() -> None:
            nonlocal edge_hits_total
            with timers.stage("writer_wait"):
                edge_hits_total += pending[1].result()  # re-raises the writer's error

        def _hand_over(batch_idx: List[int]) -> None:
            nonlocal pending, last_marks
            host, event, marks = _dispatch(batch_idx)
            if pending is not None:  # at most two batches in flight
                _wait_writer()
            pending = (batch_idx, pool.submit(_flush, batch_idx, host, event, marks,
                                              last_marks))
            last_marks = marks

        n_processed = 0
        t_start = time.perf_counter()
        with maybe_profile(profile_dir, cuda=dev.type == "cuda"):
            batch: List[int] = []
            idx = fd
            while True:
                if max_pairs is not None and idx - fd >= max_pairs:
                    break
                with timers.stage("decode_wait"):
                    fr = pf.frame(idx)
                if fr is None:
                    break
                keep = str(idx) not in done and not (
                    num_shards > 1
                    and ((idx - fd) // gop_size) % num_shards != shard_id
                )
                if keep:
                    batch.append(idx)
                    n_processed += 1
                    if len(batch) == bsz:
                        _hand_over(batch)
                        batch = []
                # GOP-window eviction: retire frames below every live window
                # (the loop's lookback, the accumulating batch, and the batch
                # the writer still holds).
                low = idx - fd
                if batch:
                    low = min(low, batch[0] - fd)
                if pending is not None:
                    low = min(low, pending[0][0] - fd)
                pf.release_below(low)
                idx += 1
            if batch:
                _hand_over(batch)
            if pending is not None:
                _wait_writer()
        wall = time.perf_counter() - t_start

        if writer is not None:
            writer.drain()
    finally:
        if startup is not None:
            timers.stop(startup)
        if pool is not None:
            pool.shutdown(wait=True)
        if pf is not None:
            pf.close()  # stop a decoder still streaming past an early exit
    ds = pf.decode_seconds()  # None unless the decode completed
    if ds is not None:
        timers.add("decode", ds)
    captures = capture_stats()

    summary = {
        "video": video_name,
        "frame_shape": [H, W],
        "pairs_processed": n_processed,
        "frame_distance": fd,
        "wall_s": wall,
        "pairs_per_s": n_processed / wall if wall > 0 else None,
        "volume_edge_hits": edge_hits_total,
        "psnr": records.summary(),
        "stages": timers.summary(),
        "counters": {
            "slots": n_slots,
            "h2d_bytes": h2d_bytes,
            "captures": captures["count"] - captures_before,
            "process_capture_s": captures["seconds"],
            "png_workers": writer.workers if writer is not None else 0,
            "needles_pooled": needles_pooled,
        },
    }
    if device_rows:
        summary["device"] = _device_summary(device_rows, entry_ns,
                                            timers.thread_spans(main_thread))
    if shard is not None:
        summary["shard"] = {"id": shard_id, "num_shards": num_shards,
                            "gop_size": gop_size}
    sum_name = (
        "summary.json" if shard is None else f"summary.rank{shard_id}.json"
    )
    with open(os.path.join(save_path, sum_name), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _device_summary(rows, entry_ns: int, main_spans) -> Dict:
    """The timed batches' device seconds by stage, and their idle gaps
    shared out among the main thread's spans: a gap of g ns that ended as
    the main thread recorded a batch's first event, at t, covers [t - g, t]
    of the host's clock; a call's first batch's, [call entry, t]."""
    gaps = [(t - gap if gap is not None else entry_ns, t) for t, gap, *_ in rows]
    return {
        "upload_s": sum(r[2] for r in rows),
        "step_s": sum(r[3] for r in rows),
        "copy_out_s": sum(r[4] for r in rows),
        "idle_s": sum(b - a for a, b in gaps) / 1e9,
        "idle_by_stage_s": attribute_idle(main_spans, gaps),
    }


# The writer's per-pair work, added up a batch: host diffs, gray PNGs and
# needle diagrams (cv2's drawing and its BGR PNG), each PNG handed to the
# pool where there is one, else written on the writer thread.
_PAIR_STAGES = ("write_outputs.diff", "write_outputs.png", "write_outputs.needle")


def _write_pair_outputs(
    save_path: str,
    idx: int,
    previous: np.ndarray,
    current: np.ndarray,
    out: Dict[str, np.ndarray],
    writer,
    spent: List[int],
) -> int:
    """One pair's five image streams; adds the ns each kind of work took
    to `spent` (in `_PAIR_STAGES`' order) and returns 1 if the pool took
    its needle diagram, else 0."""

    def emit(stream: str, name: str, img: np.ndarray) -> int:
        """Writes `img`; returns 1 if it went to the pool, else 0."""
        path = os.path.join(save_path, stream, f"{name}.png")
        if writer is None:
            write_png(path, img)
            return 0
        writer.submit(path, img)
        return 1

    def diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # host-side twin of ops.metrics.frame_difference (exact int math)
        return np.abs(a.astype(np.int32) - b.astype(np.int32)).astype(np.uint8)

    last = time.perf_counter_ns()

    def lap(kind: int) -> None:
        nonlocal last
        now = time.perf_counter_ns()
        spent[kind] += now - last
        last = now

    DIFF, PNG, NEEDLE = range(3)
    # Reference naming: frames/compensated keyed by idx-5 (results.py:64-77),
    # diffs and the needle diagram keyed by idx (results.py:86-106).
    emit("frames", str(idx - 5), previous)
    emit("compensated", str(idx - 5), out["compensated"])
    lap(PNG)
    d = diff(current, previous)
    lap(DIFF)
    emit("curr_prev_diff", str(idx), d)
    lap(PNG)
    d = diff(current, out["compensated"])
    lap(DIFF)
    emit("curr_comp_diff", str(idx), d)
    lap(PNG)
    needle = draw_motion_field(previous, out["model_motion_field"])
    pooled = emit("model_motion_field", str(idx), needle)
    lap(NEEDLE)
    return pooled


def summarize_results(out_root: str = "results") -> List[Dict]:
    """Aggregate stats over every processed video (reference utils.some_data
    and its __main__ walker, utils.py:138-188)."""
    rows = []
    for d in sorted(os.listdir(out_root)):
        rec = os.path.join(out_root, d, "psnr_records.json")
        if os.path.exists(rec):
            records = PSNRRecords(rec)
            rows.append({"video": d, **records.summary()})
    return rows
