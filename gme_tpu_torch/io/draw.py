"""Needle-diagram rendering of motion fields.

Counterpart of `gme_tpu/io/draw.py` (reference utils.py:54-76): one red
anti-aliased arrow per field cell, anchored at block centers, drawn by
OpenCV when importable, else by a dependency-free Bresenham loop; on either
path the pixels equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def _draw_line_np(img: np.ndarray, p0, p1, color) -> None:
    """Simple Bresenham fallback (no AA, no arrow head)."""
    x0, y0 = p0
    x1, y1 = p1
    dx = abs(x1 - x0)
    dy = -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    h, w = img.shape[:2]
    while True:
        if 0 <= y0 < h and 0 <= x0 < w:
            img[y0, x0] = color
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def draw_motion_field(frame: np.ndarray, motion_field: np.ndarray) -> np.ndarray:
    """Render the motion field as red arrows over the (grayscale) frame.

    Mirrors reference utils.py:54-76: arrows start at block centers and span
    (mv_x, mv_y) = field channels (0, 1); BGR color (0,0,255); AA lines.
    """
    frame = np.asarray(frame)
    motion_field = np.asarray(motion_field)
    height = frame.shape[0]
    mf_h, mf_w = motion_field.shape[:2]
    bs = height // mf_h

    if _HAS_CV2:
        canvas = cv2.cvtColor(frame, cv2.COLOR_GRAY2RGB)
    else:
        canvas = np.stack([frame] * 3, axis=-1).copy()

    for y in range(mf_h):
        for x in range(mf_w):
            ix = x * bs + bs // 2
            iy = y * bs + bs // 2
            mv_x, mv_y = motion_field[y][x][:2]
            p0 = (ix, iy)
            p1 = (int(ix + mv_x), int(iy + mv_y))
            if _HAS_CV2:
                cv2.arrowedLine(canvas, p0, p1, (0, 0, 255), 1, line_type=cv2.LINE_AA)
            else:
                _draw_line_np(canvas, p0, p1, (0, 0, 255))
    return canvas
