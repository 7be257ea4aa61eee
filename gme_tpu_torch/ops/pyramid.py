"""Gaussian pyramid in integer arithmetic (cv2.pyrDown on uint8, exactly).

Counterpart of `gme_tpu/ops/pyramid.py`.  OpenCV's pyrDown on uint8 is a
REFLECT_101 pad of 2, the separable [1,4,6,4,1] taps with stride 2, and
`(acc + 128) >> 8`.  Here the taps run on float32 strided slices: every
accumulator of a uint8 frame is an integer <= 255*256 = 65280, exact in
float32, and the division by 256 is exact, so `floor((acc + 128) / 256)` (the
JAX package's rounding) is OpenCV's on every device.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from gme_tpu_torch.utils.compiled import compiled

_W5 = (1, 4, 6, 4, 1)


def _taps_stride2(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """sum_k w5[k] * x[2i + k] along `dim`, for i < n_out."""
    acc = None
    for k, w in enumerate(_W5):
        part = x.narrow(dim, k, 2 * n_out - 1)
        part = part[:, ::2] if dim == 1 else part[:, :, ::2]
        acc = part * w if acc is None else acc + part * w
    return acc


def pyrdown(img: torch.Tensor) -> torch.Tensor:
    """Downsample one level: (B, H, W) uint8 -> (B, (H+1)//2, (W+1)//2)
    uint8, equal to cv2.pyrDown on every frame.  A float input (the direct
    path's warped frames) takes the same float32 taps, as in the JAX
    package."""
    _, H, W = img.shape
    oh, ow = (H + 1) // 2, (W + 1) // 2
    # F.pad's "reflect" is REFLECT_101; it wants a (N, C, H, W) input.
    x = F.pad(img.to(torch.float32)[:, None], (2, 2, 2, 2), mode="reflect")[:, 0]
    acc = _taps_stride2(_taps_stride2(x, 1, oh), 2, ow)
    return torch.floor((acc + 128.0) * (1.0 / 256.0)).to(torch.uint8)


def get_pyramids(img: torch.Tensor, levels: int = 3) -> List[torch.Tensor]:
    """Gaussian pyramid of a (B, H, W) uint8 batch, coarsest first
    (reference utils.py:34-51: index 0 is the most downsampled)."""
    pyramid = [img]
    curr = img
    for _ in range(1, levels):
        curr = pyrdown(curr)
        pyramid.insert(0, curr)
    return pyramid


get_pyramids_jit = compiled(get_pyramids, static_argnames=("levels",))  # JAX pyramid.py:97
