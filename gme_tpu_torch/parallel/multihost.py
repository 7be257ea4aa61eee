"""Multi-process orchestration: GOPs shard across processes.

Counterpart of `gme_tpu/parallel/multihost.py`.  Groups of `gop_size` frame
pairs shard across processes; each decodes the video itself and runs its
GOPs through `process_video`.  The per-rank `psnr_records.rank<k>.json`
files are the work manifest and the restart ledger (a restarted rank with
`resume=True` runs only its missing pairs), and rank 0 merges them into the
canonical `psnr_records.json` after the completion barrier.

Launch (one command per process):

    python -m gme_tpu_torch.cli results -v video.y4m --num-processes 2 \\
        --process-id $RANK --coordinator host0:9955

The processes join a gloo process group at the coordinator (rank 0 serves
it).  The barrier is the run's only collective; gloo serves it on the CPU
and beside a card alike, and it lets several ranks share one card, which
NCCL ranks cannot.  Without a coordinator the processes run uncoordinated
(still correct: the GOPs are disjoint); call `merge_rank_records` once all
ranks have finished.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import torch.distributed as dist

from gme_tpu_torch.config import PipelineConfig
from gme_tpu_torch.parallel.mesh import initialize_multihost


def merge_rank_records(
    save_path: str, num_processes: Optional[int] = None
) -> Dict[str, float]:
    """Merge the psnr_records.rank*.json manifests into the canonical
    psnr_records.json (reference results.py:109-112 layout) and return the
    merged records.  With `num_processes`, a manifest of any other rank
    (debris of a run with another process count) is an error."""
    paths = sorted(glob.glob(os.path.join(save_path, "psnr_records.rank*.json")))
    if num_processes is not None:
        expected = {
            os.path.join(save_path, f"psnr_records.rank{r}.json")
            for r in range(num_processes)
        }
        stale = sorted(set(paths) - expected)
        if stale:
            raise RuntimeError(
                f"stale rank manifests for num_processes={num_processes}: "
                f"{[os.path.basename(p) for p in stale]} — remove them or "
                "merge with the matching process count"
            )
    merged: Dict[str, float] = {}
    for p in paths:
        with open(p) as f:
            merged.update(json.load(f))
    merged = {k: merged[k] for k in sorted(merged, key=int)}
    with open(os.path.join(save_path, "psnr_records.json"), "w") as f:
        json.dump(merged, f, indent=4)
    return merged


def process_video_multihost(
    video_path: str,
    out_root: str = "results",
    cfg: Optional[PipelineConfig] = None,
    num_processes: int = 1,
    process_id: int = 0,
    coordinator_address: Optional[str] = None,
    gop_size: int = 16,
    max_pairs: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Run this process's GOP shard of the results pipeline on `device`.  With a
    coordinator address it joins the gloo process group, waits at the
    barrier when done, rank 0 merges the manifests, and the group is
    destroyed; without one it runs uncoordinated and the caller merges."""
    from gme_tpu_torch.pipeline.results import process_video

    distributed = num_processes > 1 and coordinator_address is not None
    if distributed:
        initialize_multihost(coordinator_address, num_processes, process_id)
    try:
        summary = process_video(
            video_path, out_root=out_root, cfg=cfg, max_pairs=max_pairs,
            shard=(process_id, num_processes) if num_processes > 1 else None,
            gop_size=gop_size, device=device,
        )
        if distributed:
            dist.barrier()
            if process_id == 0:
                video_name = os.path.splitext(os.path.basename(video_path))[0]
                merge_rank_records(os.path.join(out_root, video_name), num_processes)
    finally:
        if distributed:
            dist.destroy_process_group()
    return summary
