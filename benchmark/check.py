"""The comparison that decides `correct`.

Every clip that `process_video` finished in the window is held to the plain
reference (`reference.py`) run over the same generated frames:

- `psnr_gap_db`: the widest gap between a pair's PSNR in
  psnr_records.json and the reference's, over every pair of every clip;
- `missing_pairs`: pairs of a clip with no record (limit 0);
- `edge_hits_gap`: the widest gap between a clip's `volume_edge_hits` in
  summary.json and the reference's total (limit 0: an exact count);
- with images, on a sample of pairs drawn from the seed:
  `png_px_wrong`, the pixels of the frame, compensated-frame and both
  diff PNGs that differ from the reference's (limit 0: integers), and
  `needle_px_wrong`, the needle diagram's pixels that differ from the gray
  frame away from every reference arrow, plus the reference arrows whose
  tip the diagram does not mark (limit 0).

The limits were set from the readings in `PERF.md`: the largest gap of
sound runs of the program over a dozen seeds and more, and the smallest
gap of the control (`control.py`: the reference with its float32 steps in
bfloat16, run in the program's place and judged here as the program is).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark import reference
from benchmark.png import read_png

LIMITS = {
    "psnr_gap_db": 3e-3,
    "missing_pairs": 0,
    "edge_hits_gap": 0,
    "png_px_wrong": 0,
    "needle_px_wrong": 0,
}
# Pixels around a reference arrow where anti-aliasing may touch the canvas.
ARROW_MARGIN = 2.5


@dataclass
class Call:
    """One `process_video` call of the window: which clip, where its
    outputs went, and the summary it returned."""
    clip: int
    out_dir: str
    summary: dict


@dataclass
class Verdict:
    attempted: int = 0
    failed: int = 0
    readings: Dict[str, float] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= LIMITS[k] for k, v in self.readings.items())

    def lines(self) -> List[str]:
        return [f"{k} {v!r} limit {LIMITS[k]!r}" for k, v in self.readings.items()]

    def as_json(self) -> dict:
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in self.readings.items()}


def read_records(out_dir: str) -> Dict[int, float]:
    with open(os.path.join(out_dir, "psnr_records.json")) as f:
        return {int(k): float(v) for k, v in json.load(f).items()}


def arrow_mask(shape: Tuple[int, int], model: np.ndarray, bs: int) -> Tuple[np.ndarray, list]:
    """(pixels within ARROW_MARGIN of a reference arrow, tips of the
    arrows that have a length) for a (nbh, nbw, 2) [col, row] field,
    arrows from the block centres as the needle diagram draws them."""
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    mask = np.zeros((H, W), bool)
    tips = []
    for y in range(model.shape[0]):
        for x in range(model.shape[1]):
            x0, y0 = x * bs + bs // 2, y * bs + bs // 2
            x1, y1 = x0 + int(model[y, x, 0]), y0 + int(model[y, x, 1])
            lo_x, hi_x = max(min(x0, x1) - 4, 0), min(max(x0, x1) + 5, W)
            lo_y, hi_y = max(min(y0, y1) - 4, 0), min(max(y0, y1) + 5, H)
            if lo_x >= hi_x or lo_y >= hi_y:
                continue
            px, py = xx[lo_y:hi_y, lo_x:hi_x], yy[lo_y:hi_y, lo_x:hi_x]
            dx, dy = x1 - x0, y1 - y0
            n2 = dx * dx + dy * dy
            t = np.clip(((px - x0) * dx + (py - y0) * dy) / n2, 0, 1) if n2 else 0.0
            dist = np.hypot(px - (x0 + t * dx), py - (y0 + t * dy))
            mask[lo_y:hi_y, lo_x:hi_x] |= dist <= ARROW_MARGIN
            if n2 and 0 <= x1 < W and 0 <= y1 < H:
                tips.append((y1, x1))
    return mask, tips


def needle_wrong(img: np.ndarray, prev: np.ndarray, model: np.ndarray, bs: int) -> int:
    """Pixels of an RGB needle diagram that differ from the gray frame away
    from the reference's arrows, plus the arrows whose tip (or a pixel next
    to it) is not drawn."""
    gray = np.repeat(prev[..., None], 3, axis=2)
    mask, tips = arrow_mask(prev.shape, model, bs)
    off = (img != gray).any(axis=2) & ~mask
    drawn = (img != gray).any(axis=2)
    missing = 0
    for y, x in tips:
        if not drawn[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].any():
            missing += 1
    return int(off.sum()) + missing


def check_images(out_dir: str, idx: int, fd: int, frames: np.ndarray,
                 model: np.ndarray, comp: np.ndarray, bs: int) -> Tuple[int, int]:
    """(png_px_wrong, needle_px_wrong) of pair `idx`'s five PNGs, named as
    the driver names them (frames and compensated by idx - 5)."""
    prev, curr = frames[idx - fd], frames[idx]

    def diff(a, b):
        return np.abs(a.astype(np.int16) - b.astype(np.int16)).astype(np.uint8)

    want = {
        ("frames", idx - 5): prev,
        ("compensated", idx - 5): comp,
        ("curr_prev_diff", idx): diff(curr, prev),
        ("curr_comp_diff", idx): diff(curr, comp),
    }
    wrong = 0
    for (stream, name), ref in want.items():
        path = os.path.join(out_dir, stream, f"{name}.png")
        got = read_png(path) if os.path.exists(path) else None
        wrong += ref.size if got is None or got.shape != ref.shape else int((got != ref).sum())
    path = os.path.join(out_dir, "model_motion_field", f"{idx}.png")
    if not os.path.exists(path):
        return wrong, prev.size
    return wrong, needle_wrong(read_png(path), prev, model, bs)


def reference_clips(clips: Sequence[np.ndarray], gme: dict, fd: int, batch: int, device,
                    keep: Dict[int, set]) -> List[dict]:
    import torch

    out = []
    for c, frames in enumerate(clips):
        t = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        out.append(reference.clip(t, gme, fd, batch, keep.get(c, ())))
    return out


def judge(calls: Sequence[Call], clips: Sequence[np.ndarray], refs: Sequence[dict],
          fd: int, bs: int, image_sample: Sequence[Tuple[int, int]] = ()) -> Verdict:
    """The verdict on the window's calls against the reference of each
    clip; `image_sample` lists (call index, pair index) whose PNGs are
    read."""
    v = Verdict()
    gap = missing = hits = 0.0
    bad = set()
    for k, call in enumerate(calls):
        ref = refs[call.clip]
        got = read_records(call.out_dir)
        v.attempted += len(ref["psnr"])
        for idx, want in ref["psnr"].items():
            if idx not in got:
                missing += 1
                bad.add((k, idx))
                continue
            g = abs(got[idx] - want)
            gap = max(gap, g)
            if not g <= LIMITS["psnr_gap_db"]:
                bad.add((k, idx))
        hits = max(hits, abs(call.summary["volume_edge_hits"] - ref["volume_edge_hits"]))
    v.readings.update(psnr_gap_db=gap, missing_pairs=int(missing), edge_hits_gap=int(hits))
    if image_sample:
        px = needle = 0
        for k, idx in image_sample:
            call = calls[k]
            model, comp = refs[call.clip]["images"][idx]
            p, n = check_images(call.out_dir, idx, fd, clips[call.clip], model, comp, bs)
            px, needle = px + p, needle + n
            if p or n:
                bad.add((k, idx))
        v.readings.update(png_px_wrong=px, needle_px_wrong=needle)
    v.failed = len(bad)
    return v
