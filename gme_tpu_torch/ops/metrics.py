"""Quality metrics (counterpart of `gme_tpu/ops/metrics.py`), batched over
a leading pair dimension."""

from __future__ import annotations

import torch


def psnr(original: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """(B,) float32 peak signal-to-noise ratio in dB of (B, H, W) frames;
    -1.0 where the frames are identical (reference utils.py:112-113).

    The f32 mean spans more than 2**24 in total, so its last bits depend on
    the reduction order: it agrees with the JAX package to ~1e-5 dB, not
    bit for bit."""
    diff = original.to(torch.float32) - noisy.to(torch.float32)
    mse = (diff * diff).mean(dim=(-2, -1))
    val = 20.0 * torch.log10(255.0 / torch.sqrt(mse))
    return torch.where(mse == 0, torch.full_like(val, -1.0), val)


def frame_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| as uint8 (reference results.py:80-85).  int32 first: uint8
    subtraction wraps."""
    return (a.to(torch.int32) - b.to(torch.int32)).abs().to(torch.uint8)
