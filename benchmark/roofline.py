"""The least time the card could take for a cost-volume kernel's function.

Frozen from `chip_smoke.work` and `chip_smoke.bound` (the cost-volume
branch), on shapes instead of tensors: each input byte read once and each
output byte written once at the HBM rate, or the operations at their
unit's peak, whichever is longer.  Published H100 SXM peaks (NVIDIA's data
sheet, 700 W): 3.35 TB/s of HBM3 and 1,979 T dense int8 tensor-core
operations a second; the int32 rate outside the tensor cores is 132 SMs x
64 lanes x the 1.98 GHz boost clock.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_RATE = {"int8 tensor": INT8_TENSOR_OPS_PER_S, "int32": INT32_OPS_PER_S}
TENSOR_CORE_VOLUMES = ("cost_volume_mse_block", "cost_volume_cross")


def volume_inputs(B: int, H: int, W: int, bs: int, R: int) -> Tuple[Tuple[int, int, int],
                                                                     Tuple[int, int, int]]:
    """Shapes of a volume kernel's inputs at a level of (H, W) frames:
    the previous frames cropped to whole blocks, and the current frames
    padded by R and cropped to the crop plus 2R."""
    Hc, Wc = H // bs * bs, W // bs * bs
    return (B, Hc, Wc), (B, Hc + 2 * R, Wc + 2 * R)


def volume_work(kernel: str, prev: Tuple[int, int, int], curr: Tuple[int, int, int],
                bs: int, D: int) -> Tuple[int, float, str]:
    """(bytes, operations, kind of operation) of a cost volume: both inputs
    read once and the float32 volume written once; a u8 multiply-add (2
    operations) a pixel term on the int8 tensor cores where the kernel has
    that form, else half an int32 instruction a pixel term."""
    B, Hc, Wc = prev
    outputs = B * (Hc // bs) * (Wc // bs) * D * D
    nbytes = B * Hc * Wc + curr[0] * curr[1] * curr[2] + 4 * outputs
    if kernel in TENSOR_CORE_VOLUMES:
        return nbytes, 2 * outputs * bs * bs, "int8 tensor"
    return nbytes, outputs * bs * bs / 2, "int32"


def volume_bound_ms(kernel: str, B: int, H: int, W: int, bs: int, R: int) -> Tuple[float, str]:
    """(bound ms, "bytes" or "operations") of one launch at a level of
    (H, W) frames, B pairs, block size bs and radius R."""
    prev, curr = volume_inputs(B, H, W, bs, R)
    nbytes, ops, kind = volume_work(kernel, prev, curr, bs, 2 * R + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_RATE[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pyramid_shapes(H: int, W: int, levels: int):
    """(H, W) of each pyramid level, coarsest first (cv2.pyrDown sizes)."""
    shapes = [(H, W)]
    for _ in range(1, levels):
        H, W = (H + 1) // 2, (W + 1) // 2
        shapes.insert(0, (H, W))
    return shapes
