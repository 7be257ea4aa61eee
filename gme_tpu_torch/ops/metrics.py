"""Quality metrics (counterpart of `gme_tpu/ops/metrics.py`), batched over
a leading pair dimension."""

from __future__ import annotations

import torch


def sse(original: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """(B,) int64 sum of squared differences of (B, ..., H, W) integer frames:
    exact, so it is the same on every device, at every batch size and summed
    over row bands in any order."""
    diff = original.to(torch.int32) - noisy.to(torch.int32)
    return (diff * diff).reshape(diff.shape[0], -1).sum(dim=1, dtype=torch.int64)


def psnr_from_sse(total: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """(B,) float32 PSNR in dB of frames of `n_pixels` pixels with sums of
    squared differences `total`; -1.0 where they are 0 (reference
    utils.py:112-113).  The mean is the exact sum over the count, rounded
    to float32 once."""
    mse = (total.to(torch.float64) / n_pixels).to(torch.float32)
    val = 20.0 * torch.log10(255.0 / torch.sqrt(mse))
    return torch.where(mse == 0, torch.full_like(val, -1.0), val)


def psnr(original: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """(B,) float32 peak signal-to-noise ratio in dB of (B, H, W) frames;
    -1.0 where the frames are identical (reference utils.py:112-113).

    Integer frames take the exact SSE, so the mean is exact before its one
    rounding: it agrees with the JAX package's float32 mean (whose last bits
    depend on the reduction order) to ~1e-5 dB, and with itself bit for bit
    on every device, batch split and row-band sum.  Float frames (a warp's
    output) take the JAX package's float32 difference and mean."""
    if not (original.is_floating_point() or noisy.is_floating_point()):
        return psnr_from_sse(sse(original, noisy), original.shape[-2] * original.shape[-1])
    diff = original.to(torch.float32) - noisy.to(torch.float32)
    mse = (diff * diff).mean(dim=(-2, -1))
    val = 20.0 * torch.log10(255.0 / torch.sqrt(mse))
    return torch.where(mse == 0, torch.full_like(val, -1.0), val)


def frame_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| as uint8 (reference results.py:80-85).  int32 first: uint8
    subtraction wraps."""
    return (a.to(torch.int32) - b.to(torch.int32)).abs().to(torch.uint8)
