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
the writer waits on a CUDA event recorded after the copy, then writes the
images and, after them, the records (the image-before-record fence: the
records are the restart ledger).  Meanwhile the main thread runs the next
batch's step; at most two batches are in flight, and an error in the
writer re-raises in `process_video`.

The device is explicit: `device="cuda"` (the default) raises without CUDA;
the CPU runs only when `device="cpu"` is passed.  A mesh other than 1x1
(`cfg.mesh`) runs over the slots `devices`: by default the visible cards
on CUDA, every slot the CPU on the CPU; a list may name one device more
than once (a mesh on one card), and a mesh larger than its slots raises.
"""

from __future__ import annotations

import json
import os
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
from gme_tpu_torch.utils.profiling import StageTimer, maybe_profile

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


def _get_writer(workers: int = 2):
    """The native asynchronous PNG writer when it builds, else None
    (synchronous writes)."""
    from gme_tpu_torch.native.loader import AsyncPNGWriter, available

    return AsyncPNGWriter(workers) if available() else None


def _start_copy(out: Dict[str, torch.Tensor]):
    """Start copying a batch's outputs to the host: pinned host tensors
    filled by non-blocking copies, and the CUDA event recorded after them
    on the outputs' device (None on the CPU, where the outputs already are
    on the host)."""
    dev = next(iter(out.values())).device
    if dev.type != "cuda":
        return out, None
    host = {}
    for k, v in out.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
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

    video_name = os.path.splitext(os.path.basename(video_path))[0]
    save_path = os.path.join(out_root, video_name)
    _prepare_dirs(save_path)

    # The decoder holds at most `max_ahead` frames past the release
    # watermark: two batches in flight + frame_distance + the current peek,
    # with 2x slack.
    max_ahead = 2 * (2 * bsz + fd + 2)
    pf = FramePrefetcher(video_path, max_ahead=max_ahead)
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gme-writer")
    try:
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
        writer = _get_writer()

        def _flush(batch_idx: List[int], host, event) -> int:
            """Writer thread: wait for the batch's copy, write its images,
            then flush its records; returns its real pairs' edge hits."""
            with timers.stage("device_get"):
                if event is not None:
                    event.synchronize()
                out = {k: v.numpy() for k, v in host.items()}
            # Walks stopped on the volume boundary ring, over the real
            # (not padding) pairs of the batch.
            hits = int(out.pop("volume_edge_hits")[: len(batch_idx)].sum())
            with timers.stage("write_outputs"):
                for k, idx in enumerate(batch_idx):
                    _write_pair_outputs(
                        save_path, idx, pf.frame(idx - fd), pf.frame(idx),
                        {key: out[key][k] for key in out}, writer,
                        write_images=cfg.write_images,
                    )
                    records.add(idx, float(out["psnr"][k]))
                # Image-before-record fence: every image of these pairs is
                # on disk before the ledger marks them done.
                if writer is not None and cfg.write_images:
                    writer.drain()
                records.flush()
            return hits

        def _dispatch(batch_idx: List[int]):
            """Run the step on one batch, padded by repeating its last
            index, and start copying its outputs to the host."""
            idx_arr = batch_idx + [batch_idx[-1]] * (bsz - len(batch_idx))
            with timers.stage("dispatch"):
                prev = torch.from_numpy(np.stack([pf.frame(i - fd) for i in idx_arr]))
                curr = torch.from_numpy(np.stack([pf.frame(i) for i in idx_arr]))
                return _start_copy(step(prev.to(dev), curr.to(dev)))

        edge_hits_total = 0
        pending = None  # (batch indices, the writer's future)

        def _hand_over(batch_idx: List[int]) -> None:
            nonlocal edge_hits_total, pending
            host, event = _dispatch(batch_idx)
            if pending is not None:  # at most two batches in flight
                edge_hits_total += pending[1].result()  # re-raises the writer's error
            pending = (batch_idx, pool.submit(_flush, batch_idx, host, event))

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
                edge_hits_total += pending[1].result()
        wall = time.perf_counter() - t_start

        if writer is not None:
            writer.drain()
    finally:
        pool.shutdown(wait=True)
        pf.close()  # stop a decoder still streaming past an early exit
    ds = pf.decode_seconds()  # None unless the decode completed
    if ds is not None:
        timers.add("decode", ds)

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
    }
    if shard is not None:
        summary["shard"] = {"id": shard_id, "num_shards": num_shards,
                            "gop_size": gop_size}
    sum_name = (
        "summary.json" if shard is None else f"summary.rank{shard_id}.json"
    )
    with open(os.path.join(save_path, sum_name), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _write_pair_outputs(
    save_path: str,
    idx: int,
    previous: np.ndarray,
    current: np.ndarray,
    out: Dict[str, np.ndarray],
    writer,
    write_images: bool = True,
) -> None:
    if not write_images:
        return

    def emit(stream: str, name: str, img: np.ndarray) -> None:
        path = os.path.join(save_path, stream, f"{name}.png")
        if writer is not None and img.ndim == 2:
            writer.submit(path, img)
        else:
            write_png(path, img)

    def diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        # host-side twin of ops.metrics.frame_difference (exact int math)
        return np.abs(a.astype(np.int32) - b.astype(np.int32)).astype(np.uint8)

    # Reference naming: frames/compensated keyed by idx-5 (results.py:64-77),
    # diffs and the needle diagram keyed by idx (results.py:86-106).
    emit("frames", str(idx - 5), previous)
    emit("compensated", str(idx - 5), out["compensated"])
    emit("curr_prev_diff", str(idx), diff(current, previous))
    emit("curr_comp_diff", str(idx), diff(current, out["compensated"]))
    needle = draw_motion_field(previous, out["model_motion_field"])
    emit("model_motion_field", str(idx), needle)


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
