"""Block-based motion estimation: the diamond search on the volume engine.

Counterpart of the volume-engine path of `gme_tpu/ops/bbme.py`, batched over
a leading pair dimension B.  The volume engine precomputes the block DFD for
every offset in [-R, R]^2 (a CUDA kernel), builds the int8 LDSP rank map
over it (plain torch), chases each cell's walk to its fixpoint (a CUDA
kernel) and finishes with one SDSP pass.  All DFD values are integers below
2**24 held in float32, so every stage is bit-identical to the JAX package
run with `search_impl="volume"`.

Motion-field convention (reference bbme.py:531-532): (B, H//bs, W//bs, 2)
int32, channel 0 the column shift, channel 1 the row shift.

Not ported yet: the gather engine and the exhaustive, three-step and 2D-log
searches (ROADMAP A9), and the volume kernels for the shapes the JAX
dispatch sends to `_cost_volume_kernel` (ROADMAP B5) or
`_cross_volume_kernel` (ROADMAP B6).  Those raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from gme_tpu_torch.config import DIAMOND, MAE, MSE
from gme_tpu_torch.ops import cuda_kernels
from gme_tpu_torch.ops.cuda_kernels import LDSP

_INF = float("inf")
# SDSP offsets as the reference applies them, (row, col) swapped
# (reference bbme.py:518-521).
SDSP = ((0, 0), (0, 1), (1, 0), (0, -1), (-1, 0))


def _check_search_impl(search_impl: str) -> None:
    """`auto` is the volume engine on every device, so CPU and GPU runs are
    the same function; the gather engine is not ported."""
    if search_impl in ("auto", "volume"):
        return
    if search_impl == "gather":
        raise NotImplementedError(
            "search_impl='gather' is not ported yet (ROADMAP A9); use 'volume'"
        )
    raise ValueError(f"unknown search_impl {search_impl!r}")


def _block_origins(nbh: int, nbw: int, bs: int, device) -> torch.Tensor:
    """(nbh, nbw, 2) int32 top-left (row, col) of every block."""
    bi = torch.arange(nbh, dtype=torch.int32, device=device) * bs
    bj = torch.arange(nbw, dtype=torch.int32, device=device) * bs
    return torch.stack(torch.broadcast_tensors(bi[:, None], bj[None, :]), dim=-1)


def _dfd_cost_volume(prev_crop, curr_pad, bs: int, D: int, pnorm: int):
    """The JAX dispatch (pallas_kernels.py:622-641) over the ported kernels."""
    if bs < 8 and 8 % bs == 0 and D >= 8:
        return cuda_kernels.cost_volume_small_block(prev_crop, curr_pad, bs, D, pnorm)
    if pnorm == MSE and bs >= 8 and bs * bs * 255 * 255 < 2**24 and D >= 8:
        if bs + D - 1 <= 128:
            return cuda_kernels.cost_volume_mse_block(prev_crop, curr_pad, bs, D)
        raise NotImplementedError(
            f"MSE volume with bs={bs}, D={D} (bs + D - 1 > 128) needs the "
            "cross-volume kernel, not ported yet (ROADMAP B6)"
        )
    raise NotImplementedError(
        f"{'MAE' if pnorm == MAE else 'MSE'} volume with bs={bs}, D={D} needs "
        "the row-offset kernel, not ported yet (ROADMAP B5)"
    )


def volume_inputs(previous: torch.Tensor, current: torch.Tensor, block_size: int,
                  radius: int):
    """The volume kernels' inputs: prev cropped to whole blocks, and curr
    zero-padded by R and cropped so that the window of offset index
    (dr, dc) is curr_pad[dr:dr+Hc, dc:dc+Wc]."""
    _, H, W = previous.shape
    bs, R = block_size, radius
    Hc, Wc = H // bs * bs, W // bs * bs
    prev_crop = previous[:, :Hc, :Wc].contiguous()
    curr_pad = F.pad(current, (R, R, R, R))[:, : Hc + 2 * R, : Wc + 2 * R].contiguous()
    return prev_crop, curr_pad


def compute_cost_volume(
    previous: torch.Tensor, current: torch.Tensor, block_size: int, radius: int,
    pnorm: int,
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 DFD volume of (B, H, W) uint8 frames for
    every offset in [-R, R]^2, entry k = (dr + R) * D + (dc + R); +inf where
    the candidate block leaves the frame (reference bbme.py:157-162)."""
    _, H, W = previous.shape
    bs, R = block_size, radius
    nbh, nbw = H // bs, W // bs
    D = 2 * R + 1
    prev_crop, curr_pad = volume_inputs(previous, current, bs, R)
    cost = _dfd_cost_volume(prev_crop, curr_pad, bs, D, pnorm)

    dev = previous.device
    offsets = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)
    row0 = torch.arange(nbh, dtype=torch.int32, device=dev) * bs
    col0 = torch.arange(nbw, dtype=torch.int32, device=dev) * bs
    r = row0[:, None] + offsets[None, :]  # (nbh, D)
    c = col0[:, None] + offsets[None, :]  # (nbw, D)
    valid_r = (r >= 0) & (r <= H - bs)
    valid_c = (c >= 0) & (c <= W - bs)
    mask = valid_r[:, None, :, None] & valid_c[None, :, None, :]  # (nbh, nbw, D, D)
    # In place: the volume is the largest tensor of the step (62.7 MB per
    # 720p pair at the dense init).
    return cost.masked_fill_(~mask.reshape(nbh, nbw, D * D), _INF)


def _succ_map_packed(
    volume: torch.Tensor, origins: torch.Tensor, H: int, W: int,
    block_size: int, radius: int,
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) int8 rank map: entry [cell, o] is the index into
    LDSP of the first-minimum LDSP candidate when the cell's walk sits at
    volume offset o, with the reference's frame clamps (bbme.py:503-504)
    folded in.  Plain torch, bit-identical to the JAX package's
    `_succ_map_packed` (bbme.py:718-816): the same clamp-extended volume
    and the same exact `cost*16 + rank` int32 pack; the one-hot masked sums
    that select the clamp rows and columns there are plain indexing here."""
    bs, R = block_size, radius
    D = 2 * R + 1
    E = D + 4
    lead = volume.shape[:-1]  # (B, nbh, nbw)
    C = lead.numel()
    dev = volume.device
    vpad0 = F.pad(volume.reshape(C, D, D), (2, 2, 2, 2), value=_INF)  # (C, E, E)
    og = origins.expand(lead + (2,)).reshape(C, 2)
    lo_r, hi_r = -og[:, 0], (H - bs - 1) - og[:, 0]
    lo_c, hi_c = -og[:, 1], (W - bs - 1) - og[:, 1]
    e = torch.arange(E, dtype=torch.int32, device=dev) - (R + 2)
    cells = torch.arange(C, device=dev)

    def clamp_line(bound, take):
        # The volume line the clamp lands on; +inf when it lies outside.
        line = take((bound + R + 2).clamp(0, E - 1).long())  # (C, E)
        return torch.where((bound.abs() <= R)[:, None], line, _INF)

    # Row clamp: extended rows outside [lo_r, hi_r] read the boundary row.
    row_lo = clamp_line(lo_r, lambda i: vpad0[cells, i, :])
    row_hi = clamp_line(hi_r, lambda i: vpad0[cells, i, :])
    below, above = (e[None] < lo_r[:, None])[..., None], (e[None] > hi_r[:, None])[..., None]
    vr = torch.where(below, row_lo[:, None, :], torch.where(above, row_hi[:, None, :], vpad0))
    # Column clamp on the row-clamped tensor (corners compose exactly).
    col_lo = clamp_line(lo_c, lambda i: vr[cells, :, i])
    col_hi = clamp_line(hi_c, lambda i: vr[cells, :, i])
    left, right = (e[None] < lo_c[:, None])[:, None, :], (e[None] > hi_c[:, None])[:, None, :]
    vext = torch.where(left, col_lo[:, :, None], torch.where(right, col_hi[:, :, None], vr))

    # Costs are integers < 2**24 (bs <= 16); +inf saturates to 2**24, above
    # every real cost.  packed = cost*16 + rank < 2**31 and min(packed) is
    # the strict-< first minimum in LDSP order.
    packed = torch.clamp(vext, max=float(2**24)).to(torch.int32) * 16
    best = None
    for k, (a, b) in enumerate(LDSP):
        cand = packed[:, a + 2: a + 2 + D, b + 2: b + 2 + D] + k
        best = cand if best is None else torch.minimum(best, cand)
    return (best & 15).to(torch.int8).reshape(lead + (D * D,))


def diamond_walk_volume(
    volume: torch.Tensor, origins: torch.Tensor, H: int, W: int,
    block_size: int, radius: int, max_iters: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Volume-engine diamond walk: rank map, fixpoint chase, one SDSP pass
    (JAX bbme.py:963-1106).  Returns the (B, nbh, nbw, 2) best absolute
    positions and the (B,) int32 count of walks that visited the volume's
    boundary-adjacent ring (max |offset| >= R - 1), the certificate that a
    larger radius could not change the result when zero."""
    bs, R = block_size, radius
    D = 2 * R + 1
    if bs * bs * 255 * 255 >= 2**24:
        raise NotImplementedError(
            f"diamond search at bs={bs} > 16 needs the select-chain rank map, "
            "not ported yet (ROADMAP A9)"
        )
    lead = volume.shape[:-1]
    B = lead[0]
    rank_map = _succ_map_packed(volume, origins, H, W, bs, R)
    og = origins.expand(lead + (2,))
    bounds = torch.stack(
        [-og[..., 0], (H - bs - 1) - og[..., 0], -og[..., 1], (W - bs - 1) - og[..., 1]],
        dim=-1,
    ).reshape(-1, 4).to(torch.int32).contiguous()
    o, touched = cuda_kernels.chase_fixpoint(
        rank_map.reshape(-1, D * D), bounds, D, R, max_iters
    )
    o = o.reshape(lead)
    edge_hits = touched.reshape(B, -1).sum(dim=1, dtype=torch.int32)
    match = torch.stack([og[..., 0] + o // D - R, og[..., 1] + o % D - R], dim=-1)

    # Single SDSP pass (reference bbme.py:515-529) through the volume.
    sdsp = torch.tensor(SDSP, dtype=torch.int32, device=volume.device)
    pos = match[..., None, :] + sdsp  # (B, nbh, nbw, 5, 2)
    pos = torch.stack(
        [pos[..., 0].clamp(0, H - bs - 1), pos[..., 1].clamp(0, W - bs - 1)], dim=-1
    )
    cost = volume_evaluator(volume, og, R)(pos)
    return _take_best(pos, cost), edge_hits


def volume_evaluator(volume: torch.Tensor, origins: torch.Tensor, radius: int):
    """Evaluator over a (..., D*D) masked volume: candidate positions
    (..., K, 2) -> costs (..., K), +inf beyond `radius` of the origin."""
    D = 2 * radius + 1

    def evaluate(pos: torch.Tensor) -> torch.Tensor:
        off = pos - origins[..., None, :]
        inside = (off[..., 0].abs() <= radius) & (off[..., 1].abs() <= radius)
        k = (off[..., 0].clamp(-radius, radius) + radius) * D + (
            off[..., 1].clamp(-radius, radius) + radius
        )
        cost = torch.gather(volume, -1, k.long())
        return torch.where(inside, cost, _INF)

    return evaluate


def _take_best(pos: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """First-minimum candidate per block (the reference's strict-< scan);
    `torch.argmin` returns the first minimal index, so all-+inf rows give 0."""
    k = torch.argmin(cost, dim=-1)
    idx = k[..., None, None].expand(k.shape + (1, 2))
    return torch.gather(pos, -2, idx)[..., 0, :]


def diamond_search(
    previous: torch.Tensor, current: torch.Tensor, pnorm_distance: int = MAE,
    block_size: int = 12, max_iters: int = 4096, search_impl: str = "auto",
    volume_radius: int = 32,
):
    """Large-diamond walk until the centre wins, then one small-diamond pass
    (reference bbme.py:436-534), on the volume engine.  Candidate positions
    are clamped to [0, dim - bs - 1] as the reference does.  Returns the
    (B, nbh, nbw, 2) int32 field and the (B,) int32 `volume_edge_hits`."""
    _check_search_impl(search_impl)
    _, H, W = previous.shape
    bs = block_size
    nbh, nbw = H // bs, W // bs
    origins = _block_origins(nbh, nbw, bs, previous.device)
    radius = min(volume_radius, max(H, W))
    volume = compute_cost_volume(previous, current, bs, radius, pnorm_distance)
    best, edge_hits = diamond_walk_volume(volume, origins, H, W, bs, radius, max_iters)
    field = torch.stack(
        [best[..., 1] - origins[..., 1], best[..., 0] - origins[..., 0]], dim=-1
    ).to(torch.int32)
    return field, edge_hits


def get_motion_field(
    previous: torch.Tensor, current: torch.Tensor, block_size: int = 4,
    searching_procedure: int = DIAMOND, pnorm_distance: int = MSE,
    max_iters: int = 4096, search_impl: str = "auto", volume_radius: int = 32,
    return_diagnostics: bool = False,
):
    """(B, H//bs, W//bs, 2) int32 motion field between (B, H, W) uint8
    frame batches; with `return_diagnostics` also
    `{"volume_edge_hits": (B,) int32}`.  Only the diamond search is ported
    (ROADMAP A9 has the others)."""
    if searching_procedure != DIAMOND:
        raise NotImplementedError(
            f"searching procedure {searching_procedure} is not ported yet "
            "(ROADMAP A9); only DIAMOND (3) is"
        )
    field, edge_hits = diamond_search(
        previous, current, pnorm_distance, block_size, max_iters, search_impl,
        volume_radius,
    )
    if return_diagnostics:
        return field, {"volume_edge_hits": edge_hits}
    return field
