"""Motion compensation (block warp), counterpart of `gme_tpu/ops/warp.py`.

Boundary semantics of reference motion.py:289-321, as in the JAX package:
the block size is the frame/field row ratio; the source pixel is
(r - d[1], c - d[0]); a pixel whose source leaves the frame keeps its
original value, and so do the rows and columns beyond the field's cover.
"""

from __future__ import annotations

import torch

from gme_tpu_torch.ops import cuda_kernels
from gme_tpu_torch.utils.compiled import compiled


def compensate_frame(frame: torch.Tensor, motion_field: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W) uint8 frames by their (B, nbh, nbw, 2) int block
    fields (channel 0 column shift, channel 1 row shift) -> (B, H, W) uint8.
    The warp is a CUDA kernel on the card; the out-of-frame mask stays here,
    as it stays outside the TPU kernel."""
    B, H, W = frame.shape
    nbh, nbw = motion_field.shape[1:3]
    bs = H // nbh
    cov_h, cov_w = nbh * bs, nbw * bs

    d = motion_field.to(torch.int32).contiguous()
    warped = cuda_kernels.warp_block_field(frame.contiguous(), d, bs)

    d_px = d[:, :, None, :, None].expand(B, nbh, bs, nbw, bs, 2).reshape(B, cov_h, cov_w, 2)
    rr = torch.arange(cov_h, dtype=torch.int32, device=frame.device)[:, None]
    cc = torch.arange(cov_w, dtype=torch.int32, device=frame.device)[None, :]
    src_r = rr - d_px[..., 1]
    src_c = cc - d_px[..., 0]
    valid = (src_r >= 0) & (src_c >= 0) & (src_r < H) & (src_c < W)
    out = frame.clone()
    out[:, :cov_h, :cov_w] = torch.where(valid, warped, frame[:, :cov_h, :cov_w])
    return out


compensate_frame_jit = compiled(compensate_frame)  # JAX warp.py:131
