"""Seeded clips: a panned low-pass texture, written and read as y4m.

`synthetic_pan` is a frozen copy of `chip_smoke.synthetic_pan` (a texture
of 8x8 cells smoothed 6 times, cropped and not rolled), widened to signed
velocities; a change to `chip_smoke.py` does not move it.  The y4m writer
and parser are the benchmark's own: 4:2:0 with flat chroma, the layout a
camera or `ffmpeg -pix_fmt yuv420p` gives.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

Y4M_HEADER = "YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n"


def synthetic_pan(n_frames: int, H: int, W: int, step: Tuple[int, int], seed: int) -> np.ndarray:
    """(n_frames, H, W) uint8: a low-pass texture panned by `step` (rows,
    cols) pixels a frame, either sign, so that frame i+1 is frame i moved
    by +step.  `seed` seeds the texture (0 <= seed < 2**32)."""
    rng = np.random.RandomState(seed)
    sr, sc = step
    Hb, Wb = H + abs(sr) * (n_frames - 1), W + abs(sc) * (n_frames - 1)
    low = rng.randint(0, 256, (Hb // 8 + 1, Wb // 8 + 1)).astype(np.float32)
    base = np.kron(low, np.ones((8, 8), np.float32))[:Hb, :Wb]
    for _ in range(6):
        base = (np.roll(base, 1, 0) + np.roll(base, -1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 1) + 4 * base) / 8
    base = base.astype(np.uint8)
    last = n_frames - 1

    def origin(i: int, s: int) -> int:
        return (last - i) * s if s >= 0 else i * -s

    return np.stack([
        base[origin(i, sr):origin(i, sr) + H, origin(i, sc):origin(i, sc) + W]
        for i in range(n_frames)
    ])


def draw_clips(seed: int, speeds) -> List[dict]:
    """The clips of a run, one a speed: a texture seed, and the speed's
    (rows, cols) pixels a frame with each sign drawn from `seed` (any
    integer >= 0), the clips in an order drawn from it too.  Every seed
    pans at the same speeds, so that it changes the pixels and not the
    work: a writer's compression and a walk's length follow the speed."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(speeds))
    clips = []
    for k in order:
        texture = int(rng.integers(0, 2**32))
        sign = rng.choice([-1, 1], size=2)
        step = (int(sign[0] * speeds[k][0]), int(sign[1] * speeds[k][1]))
        clips.append({"texture_seed": texture, "step": step})
    return clips


def write_y4m(path: str, frames: np.ndarray) -> int:
    """Write (N, H, W) uint8 luma frames as a 4:2:0 y4m with flat chroma
    (128); returns the bytes written."""
    n, h, w = frames.shape
    chroma = np.full(2 * ((h + 1) // 2) * ((w + 1) // 2), 128, np.uint8).tobytes()
    header = Y4M_HEADER.format(w=w, h=h).encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(fr).tobytes())
            f.write(chroma)
    return os.path.getsize(path)


def read_y4m(path: str) -> np.ndarray:
    """(N, H, W) uint8 luma planes of a 4:2:0 y4m written by `write_y4m`."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"\n")
    fields = data[:end].decode("ascii").split()
    if fields[0] != "YUV4MPEG2":
        raise ValueError(f"{path}: not a y4m file")
    size = {t[0]: t[1:] for t in fields[1:]}
    w, h = int(size["W"]), int(size["H"])
    if not size.get("C", "420").startswith("420"):
        raise ValueError(f"{path}: only 4:2:0 is read here")
    frame_bytes = w * h + 2 * ((h + 1) // 2) * ((w + 1) // 2)
    frames, pos = [], end + 1
    while pos < len(data):
        if not data.startswith(b"FRAME", pos):
            raise ValueError(f"{path}: corrupt frame header at byte {pos}")
        pos = data.index(b"\n", pos) + 1
        frames.append(np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w))
        pos += frame_bytes
    return np.stack(frames)
