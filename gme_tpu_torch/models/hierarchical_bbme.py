"""Hierarchical (coarse-to-fine) block matching, batched over pairs.

Counterpart of `gme_tpu/models/hierarchical_bbme.py` (reference
bbme.py:537-605): refines a motion field across pyramid levels, with the
reference's quirks kept:

- the upscale repeats each cell 2x2, truncates toward zero and doubles;
- the coarsest level runs the requested procedure, every finer level
  diamond (reference bbme.py:588-594 hard-codes 3);
- when the upscaled field is one row or column short, one zero row or else
  one zero column is appended (bbme.py:596-602);
- the average (old + new) / 2 is a true division: the field is float32.
"""

from __future__ import annotations

import torch

from gme_tpu_torch.config import DIAMOND
from gme_tpu_torch.ops.bbme import get_motion_field
from gme_tpu_torch.ops.pyramid import get_pyramids


def rescale_motion_field(motion_field: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(B, nbh, nbw, 2) field -> (B, nbh*scale, nbw*scale, 2) int32: cells
    repeated, float values truncated toward zero, then doubled whatever
    `scale` is (reference bbme.py:537-546)."""
    mf = motion_field.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
    return torch.trunc(mf.to(torch.float32)).to(torch.int32) * 2


def hierarchical_wrapper(
    previous: torch.Tensor, current: torch.Tensor, block_size: int = 10,
    search_window: int = 4, searching_procedure: int = DIAMOND, levels: int = 3,
    max_iters: int = 4096,
) -> torch.Tensor:
    """Coarse-to-fine block matching of (B, H, W) uint8 batches over a
    Gaussian pyramid (reference bbme.py:549-605); a float32 field."""
    previous_pyr = get_pyramids(previous, levels)
    current_pyr = get_pyramids(current, levels)
    motion_field = get_motion_field(
        previous_pyr[0], current_pyr[0], block_size=block_size,
        search_window=search_window, searching_procedure=searching_procedure,
        max_iters=max_iters,
    ).to(torch.float32)
    for level in range(1, levels):
        motion_field = rescale_motion_field(motion_field)
        new_mf = get_motion_field(
            previous_pyr[level], current_pyr[level], block_size=block_size,
            search_window=search_window, searching_procedure=DIAMOND,
            max_iters=max_iters,
        ).to(torch.float32)
        if motion_field.shape != new_mf.shape:
            B, nbh, nbw, _ = motion_field.shape
            if nbh != new_mf.shape[1]:
                filler = motion_field.new_zeros((B, 1, nbw, 2))
                motion_field = torch.cat([motion_field, filler], dim=1)
            else:
                filler = motion_field.new_zeros((B, nbh, 1, 2))
                motion_field = torch.cat([motion_field, filler], dim=2)
        motion_field = (motion_field + new_mf) / 2
    return motion_field
