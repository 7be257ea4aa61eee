"""Block-based motion estimation: the four searches on two engines.

Counterpart of `gme_tpu/ops/bbme.py`, batched over a leading pair dimension
B.  Searches: exhaustive (a masked cost volume and a first-minimum argmin),
three-step (three static 9-point rounds), 2D-log (a lockstep loop with
per-block masks) and diamond (an LDSP walk and one SDSP pass), each with the
reference's tie-breaking and quirks.

The data-dependent searches evaluate candidates on one of two engines:

- "volume": the block DFD for every offset in [-R, R]^2 as a cost volume (a
  CUDA kernel), then lookups into it.  The diamond walk is chased to its
  fixpoint on the volume itself (a CUDA kernel that takes each step's rank
  from the nine candidate costs): the JAX package's int8 LDSP rank map,
  built beforehand for every offset because a TPU kernel cannot gather,
  stays here (`_succ_map`) for the tests and the rank-map chase only.
  Walks that reach the volume's edge are counted in `volume_edge_hits`.
- "gather": the candidate blocks gathered from the frame, exact for any
  walk length.

`search_impl="auto"` is the volume engine on every device, so the CPU run
and the card run are one function.  The JAX package's "auto" means the
gather engine on the CPU; the two engines agree wherever `volume_edge_hits`
is 0 (and three-step and exhaustive are exact on both).

All DFD values are integer sums taken in int32 and rounded to float32 once:
exact below 2**24 (every block size up to 16), so every stage is
bit-identical to the JAX package.  The walk compares float costs, so it
needs no `cost*16 + rank` pack at any block size; it follows the rank map's
clamp rule of the block size (`_packed_rule`).

Motion-field convention (reference bbme.py:531-532): (B, H//bs, W//bs, 2)
int32, channel 0 the column shift, channel 1 the row shift.

The row-band volume `compute_cost_volume_band` and the `count_mask` of
`diamond_walk_volume` serve the spatially-sharded step
(`gme_tpu_torch/parallel/spatial.py`).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from gme_tpu_torch.config import (
    DIAMOND, EXHAUSTIVE, MAE, MSE, THREESTEP, TWODLOG, BBMEConfig,
)
from gme_tpu_torch.ops import cuda_kernels
from gme_tpu_torch.ops.cuda_kernels import LDSP
from gme_tpu_torch.utils.compiled import compiled, while_loop

_INF = float("inf")
# SDSP offsets as the reference applies them, (row, col) swapped
# (reference bbme.py:518-521).
SDSP = ((0, 0), (0, 1), (1, 0), (0, -1), (-1, 0))
# Padding candidates of the 2D-log cross pattern: far out of every frame.
_FAR = -(2**31) // 4
# Steps of the 2D-log and gather-diamond loops between two tests of their
# condition (`utils.compiled.while_loop`: eagerly a read by the host, in a
# CUDA graph a WHILE node's run of its body), after the steps every walk
# takes.
LOOP_CHUNK = 4

# An evaluator maps candidate positions (B, nbh, nbw, K, 2) and a validity
# mask (B, nbh, nbw, K) to DFD costs (B, nbh, nbw, K), +inf where invalid.
Evaluator = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# DFD primitives and geometry (JAX bbme.py:67-126)
# ---------------------------------------------------------------------------

def block_dfd(diff: torch.Tensor, pnorm: int) -> torch.Tensor:
    """Sum of |diff| (MAE) or diff**2 (MSE) over the trailing two (block)
    dims of an int32 difference, rounded to float32 once."""
    if pnorm == MAE:
        per_px = diff.abs()
    elif pnorm == MSE:
        per_px = diff * diff
    else:
        raise ValueError(f"unknown pnorm index {pnorm}")
    return per_px.sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)


def _offset_table(rows, device) -> torch.Tensor:
    """(K, 2) int32 table of small (row, col) offsets in [-4, 3], made on
    `device` from one integer code of 3 bits an entry: no copy from the
    host, which a CUDA graph capture does not allow."""
    flat = [v for row in rows for v in row]
    code = sum((v + 4) << (3 * i) for i, v in enumerate(flat))
    shifts = torch.arange(len(flat), dtype=torch.int64, device=device) * 3
    vals = (torch.full_like(shifts, code) >> shifts) & 7
    return (vals - 4).to(torch.int32).reshape(-1, 2)


def _block_grid(height: int, width: int, bs: int) -> Tuple[int, int]:
    """Block rows and columns: the reference's loop count
    (range(0, dim-(bs-1), bs) has dim//bs elements)."""
    return height // bs, width // bs


def _block_origins(nbh: int, nbw: int, bs: int, device) -> torch.Tensor:
    """(nbh, nbw, 2) int32 top-left (row, col) of every block."""
    bi = torch.arange(nbh, dtype=torch.int32, device=device) * bs
    bj = torch.arange(nbw, dtype=torch.int32, device=device) * bs
    return torch.stack(torch.broadcast_tensors(bi[:, None], bj[None, :]), dim=-1)


def _batched_origins(previous: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, nbh, nbw, 2) block origins of a (B, H, W) batch."""
    B, H, W = previous.shape
    nbh, nbw = _block_grid(H, W, bs)
    return _block_origins(nbh, nbw, bs, previous.device).expand(B, nbh, nbw, 2)


def _anchor_blocks(frame: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, nbh, nbw, bs, bs) anchor blocks of a (B, H, W) frame batch."""
    B, H, W = frame.shape
    nbh, nbw = _block_grid(H, W, bs)
    x = frame[:, : nbh * bs, : nbw * bs]
    return x.reshape(B, nbh, bs, nbw, bs).permute(0, 1, 3, 2, 4)


def _gather_blocks(frame: torch.Tensor, pos: torch.Tensor, bs: int) -> torch.Tensor:
    """bs x bs blocks of a (B, H, W) frame batch at in-frame top-left
    positions pos (B, ..., 2) (row, col): (B, ..., bs, bs)."""
    B, H, W = frame.shape
    ar = torch.arange(bs, dtype=pos.dtype, device=pos.device)
    rows = pos[..., 0:1] + ar
    cols = pos[..., 1:2] + ar
    idx = (rows[..., :, None] * W + cols[..., None, :]).long()
    flat = frame.reshape(B, H * W).gather(1, idx.reshape(B, -1))
    return flat.reshape(idx.shape)


def _in_frame(pos: torch.Tensor, bs: int, H: int, W: int) -> torch.Tensor:
    """The reference's validity test: the candidate block lies wholly inside
    the frame (bbme.py:157-162)."""
    return ((pos[..., 0] >= 0) & (pos[..., 1] >= 0)
            & (pos[..., 0] + bs - 1 <= H - 1) & (pos[..., 1] + bs - 1 <= W - 1))


# ---------------------------------------------------------------------------
# Cost volumes
# ---------------------------------------------------------------------------

def _dfd_cost_volume_mse_decomp(prev_crop, curr_pad, bs: int, D: int) -> torch.Tensor:
    """MSE volume as sum a^2 - 2 sum ab + sum b^2 (JAX
    pallas_kernels.py:511), in int32, rounded to float32 once: bit-equal to
    the direct MSE volume.  On a CUDA tensor one launch of the cross kernel,
    which forms sum a^2 and sum b^2 in its epilogue; on the CPU its plain
    version, the decomposition in plain torch."""
    return cuda_kernels.cost_volume_cross(prev_crop, curr_pad, bs, D, ssd=True)


def _dfd_cost_volume(prev_crop, curr_pad, bs: int, D: int, pnorm: int):
    """The JAX dispatch (pallas_kernels.py:622-641) over the ported kernels:
    (B, nbh, nbw, D*D) float32, entry dr*D + dc."""
    if bs < 8 and 8 % bs == 0 and D >= 8:
        return cuda_kernels.cost_volume_small_block(prev_crop, curr_pad, bs, D, pnorm)
    if pnorm == MSE and bs >= 8 and bs * bs * 255 * 255 < 2**24 and D >= 8:
        if bs + D - 1 <= 128:
            return cuda_kernels.cost_volume_mse_block(prev_crop, curr_pad, bs, D)
        return _dfd_cost_volume_mse_decomp(prev_crop, curr_pad, bs, D)
    return cuda_kernels.cost_volume_rowoffset(prev_crop, curr_pad, bs, D, pnorm)


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


def _offset_mask(n: int, bs: int, dim: int, offsets: torch.Tensor) -> torch.Tensor:
    """(n, D) validity of each block origin along one axis moved by each
    offset: the moved block stays inside [0, dim)."""
    p = torch.arange(n, dtype=torch.int32, device=offsets.device)[:, None] * bs + offsets
    return (p >= 0) & (p <= dim - bs)


def compute_cost_volume(
    previous: torch.Tensor, current: torch.Tensor, block_size: int, radius: int,
    pnorm: int,
) -> torch.Tensor:
    """(B, nbh, nbw, D*D) float32 DFD volume of (B, H, W) uint8 frames for
    every offset in [-R, R]^2, entry k = (dr + R) * D + (dc + R); +inf where
    the candidate block leaves the frame (reference bbme.py:157-162)."""
    _, H, W = previous.shape
    prev_crop, curr_pad = volume_inputs(previous, current, block_size, radius)
    cost = _dfd_cost_volume(prev_crop, curr_pad, block_size, 2 * radius + 1, pnorm)
    return mask_volume_(cost, H, W, block_size, radius)


def mask_volume_(cost: torch.Tensor, H: int, W: int, block_size: int, radius: int) -> torch.Tensor:
    """+inf, in place, in the entries of a (B, nbh, nbw, D*D) volume of an
    (H, W) frame whose candidate block leaves the frame; returns `cost`."""
    bs, R = block_size, radius
    nbh, nbw, D = cost.shape[1], cost.shape[2], 2 * radius + 1
    offsets = torch.arange(-R, R + 1, dtype=torch.int32, device=cost.device)
    valid_r = _offset_mask(nbh, bs, H, offsets)
    valid_c = _offset_mask(nbw, bs, W, offsets)
    mask = valid_r[:, None, :, None] & valid_c[None, :, None, :]  # (nbh, nbw, D, D)
    # In place: the volume is the largest tensor of the step (62.7 MB per
    # 720p pair at the dense init).
    return cost.masked_fill_(~mask.reshape(nbh, nbw, D * D), _INF)


def compute_cost_volume_band(
    prev_band: torch.Tensor, curr_band_ext: torch.Tensor, gb0, frame_shape: Tuple[int, int],
    block_size: int, radius: int, pnorm: int,
) -> torch.Tensor:
    """(B, T, nbw, D*D) masked DFD volume of a row band of block rows (JAX
    bbme.py:229-277), through the volume kernels like `compute_cost_volume`.

    prev_band: (B, T*bs, nbw*bs) uint8, the previous-frame rows
    [gb0*bs, (gb0+T)*bs), zero past the frame's bottom; curr_band_ext:
    (B, T*bs + 2R, nbw*bs + 2R) uint8, the current-frame rows
    [gb0*bs - R, (gb0+T)*bs + R), zero beyond the frame, columns padded by
    R; gb0: the global block row of the band's first row, an int or a (B,)
    tensor (bands stacked into the pair dimension); frame_shape: the global
    (H, W).  +inf where the candidate block leaves the global frame; entry
    k = (dr + R) * D + (dc + R)."""
    H, W = frame_shape
    bs, R = block_size, radius
    T, nbw = prev_band.shape[1] // bs, prev_band.shape[2] // bs
    D = 2 * R + 1
    cost = _dfd_cost_volume(prev_band, curr_band_ext, bs, D, pnorm)
    dev = prev_band.device
    offsets = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)
    gb0 = torch.as_tensor(gb0, dtype=torch.int32, device=dev).reshape(-1, 1)
    row = ((gb0 + torch.arange(T, dtype=torch.int32, device=dev)) * bs)[..., None] + offsets
    valid_r = (row >= 0) & (row <= H - bs)  # (B or 1, T, D)
    valid_c = _offset_mask(nbw, bs, W, offsets)  # (nbw, D)
    mask = valid_r[:, :, None, :, None] & valid_c[None, None, :, None, :]
    return cost.masked_fill_(~mask.reshape(-1, T, nbw, D * D), _INF)


# ---------------------------------------------------------------------------
# Candidate evaluators (JAX bbme.py:138-331)
# ---------------------------------------------------------------------------

def _make_gather_evaluator(previous, current, bs: int, pnorm: int) -> Evaluator:
    """Exact evaluator: gather the candidate blocks and diff them against
    the anchors, in int32."""
    _, H, W = previous.shape
    anchors = _anchor_blocks(previous, bs).to(torch.int32)[..., None, :, :]

    def evaluate(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        safe = torch.stack([pos[..., 0].clamp(0, H - bs), pos[..., 1].clamp(0, W - bs)], dim=-1)
        blocks = _gather_blocks(current, safe, bs).to(torch.int32)
        cost = block_dfd(blocks - anchors, pnorm)
        return torch.where(valid, cost, _INF)

    return evaluate


def volume_evaluator(volume: torch.Tensor, origins: torch.Tensor, radius: int) -> Evaluator:
    """Evaluator over a (B, nbh, nbw, D*D) masked volume with origins
    (B, nbh, nbw, 2): +inf beyond `radius` of the origin."""
    D = 2 * radius + 1

    def evaluate(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        off = pos - origins[..., None, :]
        inside = (off[..., 0].abs() <= radius) & (off[..., 1].abs() <= radius)
        k = (off[..., 0].clamp(-radius, radius) + radius) * D + (
            off[..., 1].clamp(-radius, radius) + radius
        )
        cost = torch.gather(volume, -1, k.long())
        return torch.where(valid & inside, cost, _INF)

    return evaluate


def _resolve_impl(search_impl: str) -> str:
    """"auto" is the volume engine on every device (module docstring)."""
    if search_impl == "auto":
        return "volume"
    if search_impl not in ("gather", "volume"):
        raise ValueError(f"unknown search_impl {search_impl!r}")
    return search_impl


def _make_evaluator(previous, current, bs: int, pnorm: int, impl: str,
                    radius: int) -> Evaluator:
    if _resolve_impl(impl) == "volume":
        _, H, W = previous.shape
        # No point covering offsets larger than any in-frame displacement.
        radius = min(radius, max(H, W))
        volume = compute_cost_volume(previous, current, bs, radius, pnorm)
        return volume_evaluator(volume, _batched_origins(previous, bs), radius)
    return _make_gather_evaluator(previous, current, bs, pnorm)


def _take_best(pos: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """First-minimum candidate per block (the reference's strict-< scan);
    `torch.argmin` returns the first minimal index, so all-+inf rows give 0."""
    k = torch.argmin(cost, dim=-1)
    idx = k[..., None, None].expand(k.shape + (1, 2))
    return torch.gather(pos, -2, idx)[..., 0, :]


def _field(best: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
    """Best absolute positions -> the (col shift, row shift) int32 field."""
    return torch.stack(
        [best[..., 1] - origins[..., 1], best[..., 0] - origins[..., 0]], dim=-1
    ).to(torch.int32)


# ---------------------------------------------------------------------------
# Exhaustive search (JAX bbme.py:345-418)
# ---------------------------------------------------------------------------

def exhaustive_inputs(previous: torch.Tensor, current: torch.Tensor, block_size: int,
                      search_window: int):
    """The volume kernels' inputs for the window range(-sw, sw + bs): offset
    index k is offset k - sw, so curr is padded by sw at the top and left and
    by nb*bs + sw + bs - 1 - dim at the bottom and right (JAX
    bbme.py:382-388)."""
    _, H, W = previous.shape
    bs, sw = block_size, search_window
    nbh, nbw = _block_grid(H, W, bs)
    prev_crop = previous[:, : nbh * bs, : nbw * bs].contiguous()
    curr_k = F.pad(current, (sw, nbw * bs + sw + bs - 1 - W,
                             sw, nbh * bs + sw + bs - 1 - H)).contiguous()
    return prev_crop, curr_k


def exhaustive_search(
    previous: torch.Tensor, current: torch.Tensor, pnorm_distance: int = MAE,
    block_size: int = 4, search_window: int = 2,
) -> torch.Tensor:
    """Full scan as a masked cost volume and a first-minimum argmin.
    Candidate offsets span range(-sw, sw + bs) on both axes (the reference's
    asymmetric window, bbme.py:146-149); the scan runs column offset outer,
    row offset inner, which fixes tie-breaking."""
    _, H, W = previous.shape
    bs, sw = block_size, search_window
    nbh, nbw = _block_grid(H, W, bs)
    D = 2 * sw + bs
    vol = _dfd_cost_volume(*exhaustive_inputs(previous, current, bs, sw), bs, D, pnorm_distance)
    cost = vol.reshape(-1, nbh, nbw, D, D).transpose(-1, -2)  # (B, nbh, nbw, D_wc, D_wr)
    offsets = torch.arange(-sw, sw + bs, dtype=torch.int32, device=previous.device)
    valid_r = _offset_mask(nbh, bs, H, offsets)  # (nbh, D_wr)
    valid_c = _offset_mask(nbw, bs, W, offsets)  # (nbw, D_wc)
    mask = valid_r[:, None, None, :] & valid_c[None, :, :, None]
    cost = cost.masked_fill(~mask, _INF).reshape(-1, nbh, nbw, D * D)
    k = torch.argmin(cost, dim=-1)  # first minimum == the reference's strict-< scan
    return torch.stack([offsets[k // D], offsets[k % D]], dim=-1)


# ---------------------------------------------------------------------------
# Three-step search (JAX bbme.py:425-534)
# ---------------------------------------------------------------------------

def _nine_offsets(step: int, device) -> torch.Tensor:
    """(9, 2) int32 (row, col) offsets in the reference's scan order,
    window_col outer, window_row inner (bbme.py:229-231): entry k is
    ((k % 3 - 1) * step, (k // 3 - 1) * step)."""
    k = torch.arange(9, dtype=torch.int32, device=device)
    return torch.stack([(k % 3 - 1) * step, (k // 3 - 1) * step], dim=-1)


def _threestep_steps(block_size: int, search_window: int) -> Tuple[int, int, int]:
    """Step sizes (2sw+bs)//{3,5,10} (reference bbme.py:211-213)."""
    n = 2 * search_window + block_size
    return n // 3, n // 5, n // 10


def threestep_search_radius(block_size: int, search_window: int) -> int:
    """Exact bound on any position three-step evaluates: step 1's
    displacement counts twice through the compounded step-3 origin."""
    s1, s2, s3 = _threestep_steps(block_size, search_window)
    return 2 * s1 + s2 + s3


def threestep_walk(
    evaluate: Evaluator, origins: torch.Tensor, H: int, W: int,
    block_size: int, search_window: int,
) -> torch.Tensor:
    """The three 9-candidate rounds on (B, nbh, nbw, 2) origins, with the
    reference's compounding step-3 origin and stale-tmp quirk
    (bbme.py:292-301, 335-336).  Returns the (row, col) displacement."""
    bs = block_size
    s1, s2, s3 = _threestep_steps(bs, search_window)

    def round_best(center, step):
        offs = _nine_offsets(step, center.device)
        pos = center[..., None, :] + offs
        cost = evaluate(pos, _in_frame(pos, bs, H, W))
        return offs[torch.argmin(cost, dim=-1)], torch.isfinite(cost).any(dim=-1)

    best1, _ = round_best(origins, s1)  # the centre is always in frame
    d = best1
    origin2 = origins + d
    best2, _ = round_best(origin2, s2)
    d = d + best2
    origin3 = origin2 + d  # compounds d again (bbme.py:300-301)
    best3, any3 = round_best(origin3, s3)
    # No step-3 candidate in frame: step 2's best is added again.
    return d + torch.where(any3[..., None], best3, best2)


def threestep_search(
    previous: torch.Tensor, current: torch.Tensor, pnorm_distance: int = MAE,
    block_size: int = 4, search_window: int = 12, search_impl: str = "auto",
    volume_radius: int = 32,
) -> torch.Tensor:
    """Three shrinking 9-point rounds.  The volume radius is the exact static
    bound, so the volume engine is exact here and `volume_radius` is unused."""
    del volume_radius
    _, H, W = previous.shape
    bs, sw = block_size, search_window
    radius = threestep_search_radius(bs, sw)
    evaluate = _make_evaluator(previous, current, bs, pnorm_distance, search_impl, radius)
    d = threestep_walk(evaluate, _batched_origins(previous, bs), H, W, bs, sw)
    return torch.stack([d[..., 1], d[..., 0]], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# 2D-log search (JAX bbme.py:541-656)
# ---------------------------------------------------------------------------

def twodlog_search(
    previous: torch.Tensor, current: torch.Tensor, pnorm_distance: int = MAE,
    block_size: int = 4, search_window: int = 12, max_iters: int = 4096,
    search_impl: str = "auto", volume_radius: int = 32,
    return_diagnostics: bool = False,
):
    """Cross-pattern logarithmic search as a lockstep loop over every block
    of the batch; finished blocks are masked.  Candidate order matches the
    reference (cross: centre, +x, -x, +y, -y, bbme.py:389-393; step 2: the
    row-major 3x3 neighbourhood, bbme.py:396-398), so ties break alike.

    `volume_edge_hits` (B,) counts the walks (volume engine only) whose
    displacement plus step reached the volume radius max(volume_radius,
    2*sw), where a candidate could read +inf through the radius mask; 0
    means the field equals the unbounded gather engine's.

    The loop runs floor(log2(sw)) steps, then chunks of LOOP_CHUNK steps
    while its condition holds (`utils.compiled.while_loop`, JAX's
    `lax.while_loop`: a WHILE node in a CUDA graph); an iteration count on
    the device keeps `max_iters` exact."""
    B, H, W = previous.shape
    bs, sw = block_size, search_window
    radius = max(volume_radius, 2 * sw)
    volume_engine = _resolve_impl(search_impl) == "volume"
    evaluate = _make_evaluator(previous, current, bs, pnorm_distance, search_impl, radius)
    origins = _batched_origins(previous, bs)
    dev = previous.device

    x, y = origins[..., 0].clone(), origins[..., 1].clone()
    step = torch.full_like(x, sw)
    touched = torch.zeros(x.shape, dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    # The row-major 3x3 neighbourhood at distance 2: ((k // 3 - 1) * 2, (k % 3 - 1) * 2).
    k9 = torch.arange(9, dtype=torch.int32, device=dev)
    neigh9 = torch.stack([(k9 // 3 - 1) * 2, (k9 % 3 - 1) * 2], dim=-1)
    far = torch.full(x.shape + (4, 2), _FAR, dtype=torch.int32, device=dev)

    def body(state):
        # One lockstep step; a block is active while its step exceeds 1
        # and the loop has made fewer than max_iters steps.
        x, y, dx, dy, step, touched, it = state
        zero = torch.zeros_like(step)
        cross = torch.stack([torch.stack(v, dim=-1) for v in (
            (zero, zero), (step, zero), (-step, zero), (zero, step), (zero, -step))], dim=-2)
        offs = torch.where((step == 2)[..., None, None], neigh9,
                           torch.cat([cross, far], dim=-2))
        pos = torch.stack([x, y], dim=-1)[..., None, :] + offs
        best = _take_best(pos, evaluate(pos, _in_frame(pos, bs, H, W)))
        ndx, ndy = best[..., 0], best[..., 1]
        halve = ((ndx == x) & (ndy == y)) | (step == 2)
        nstep = torch.where(halve, step // 2, step)
        active = (step > 1) & (it < max_iters)
        disp = torch.maximum((x - origins[..., 0]).abs(), (y - origins[..., 1]).abs())
        touched = touched | (active & (disp + step > radius))
        return (torch.where(active, ndx, x), torch.where(active, ndy, y),
                torch.where(active, ndx, dx), torch.where(active, ndy, dy),
                torch.where(active, nstep, step), touched, it + 1)

    def cond(state):
        return (state[4] > 1).any() & (state[6] < max_iters)

    state = (x, y, torch.zeros_like(x), torch.zeros_like(y), step, touched, it)
    # Every walk halves its step at most once a step, so none ends before
    # floor(log2(sw)) steps: those run with no read of the condition.
    for _ in range(max(sw, 1).bit_length() - 1):
        state = body(state)
    _, _, dx, dy, _, touched, _ = while_loop(cond, body, state, LOOP_CHUNK)
    # Reference bbme.py:430-431: channel 1 = dx - block_row, 0 = dy - block_col.
    field = _field(torch.stack([dx, dy], dim=-1), origins)
    if return_diagnostics:
        if volume_engine:
            hits = touched.reshape(B, -1).sum(dim=1, dtype=torch.int32)
        else:  # gather-engine walks are unbounded
            hits = torch.zeros(B, dtype=torch.int32, device=dev)
        return field, {"volume_edge_hits": hits}
    return field


# ---------------------------------------------------------------------------
# Diamond search (JAX bbme.py:663-1158)
# ---------------------------------------------------------------------------

def _clamped(pos: torch.Tensor, H: int, W: int, bs: int) -> torch.Tensor:
    """Positions clamped to [0, dim - bs - 1], the reference's off-by-one
    clamp (bbme.py:503-504, 522-523)."""
    return torch.stack([pos[..., 0].clamp(0, H - bs - 1), pos[..., 1].clamp(0, W - bs - 1)],
                       dim=-1)


def diamond_walk(
    evaluate: Evaluator, origins: torch.Tensor, H: int, W: int,
    block_size: int, max_iters: int = 4096,
) -> torch.Tensor:
    """The gather-engine diamond walk: LDSP steps in lockstep until every
    block's centre wins, then one SDSP pass (JAX bbme.py:672-715).  Returns
    the best absolute positions, shaped like `origins`.  The loop runs one
    step, then chunks of LOOP_CHUNK steps, as `twodlog_search`'s."""
    dev = origins.device
    ldsp = _offset_table(LDSP, dev)
    sdsp = _offset_table(SDSP, dev)

    def eval_at(offsets, match):
        pos = _clamped(match[..., None, :] + offsets, H, W, block_size)
        return _take_best(pos, evaluate(pos, torch.ones(pos.shape[:-1], dtype=torch.bool,
                                                        device=dev)))

    def body(state):
        # One LDSP step of every walk not yet done, within max_iters steps.
        match, done, it = state
        go = it < max_iters
        best = eval_at(ldsp, match)
        moved = torch.where((~done & go)[..., None], best, match)
        return moved, done | (go & (best == match).all(dim=-1)), it + 1

    def cond(state):
        return (~state[1]).any() & (state[2] < max_iters)

    done = torch.zeros(origins.shape[:-1], dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    # Every walk takes one step at least.
    match, _, _ = while_loop(cond, body, body((origins, done, it)), LOOP_CHUNK)
    return eval_at(sdsp, match)


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


def _succ_map_select(
    volume: torch.Tensor, origins: torch.Tensor, H: int, W: int,
    block_size: int, radius: int,
) -> torch.Tensor:
    """The same rank map as `_succ_map_packed`, by a select chain (JAX
    bbme.py:828-960): per LDSP candidate, the volume shifted by the
    candidate, with the frame clamps folded in as saturation to the
    boundary rows, columns and corners; reduced by a strict-< first minimum
    in LDSP order.  It compares float32 costs, so it needs no exact pack and
    takes any block size."""
    bs, R = block_size, radius
    D = 2 * R + 1
    lead = volume.shape[:-1]
    C = lead.numel()
    dev = volume.device
    Vg = volume.reshape(C, D, D)
    og = origins.expand(lead + (2,)).reshape(C, 2)
    # Frame clamp bounds in offset space (reference bbme.py:503-504).
    lo_r, hi_r = -og[:, 0], (H - bs - 1) - og[:, 0]
    lo_c, hi_c = -og[:, 1], (W - bs - 1) - og[:, 1]
    cells = torch.arange(C, device=dev)

    def grid(b):
        return (b.clamp(-R, R) + R).long()

    def inside(b):
        return b.abs() <= R

    # The row or column a saturated candidate lands on, +inf when that
    # boundary lies outside the volume; corners from the masked rows.
    row_lo = torch.where(inside(lo_r)[:, None], Vg[cells, grid(lo_r), :], _INF)  # (C, D)
    row_hi = torch.where(inside(hi_r)[:, None], Vg[cells, grid(hi_r), :], _INF)
    col_lo = torch.where(inside(lo_c)[:, None], Vg[cells, :, grid(lo_c)], _INF)
    col_hi = torch.where(inside(hi_c)[:, None], Vg[cells, :, grid(hi_c)], _INF)

    def corner(row, bc):
        return torch.where(inside(bc), row[cells, grid(bc)], _INF)[:, None, None]

    c_ll, c_lh = corner(row_lo, lo_c), corner(row_lo, hi_c)
    c_hl, c_hh = corner(row_hi, lo_c), corner(row_hi, hi_c)

    vpad = F.pad(Vg, (2, 2, 2, 2), value=_INF)
    o_grid = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)

    def shift1d(x, s):
        """x (C, D) shifted by s with +inf padding: out[:, i] = x[:, i + s]."""
        return F.pad(x, (2, 2), value=_INF)[:, s + 2: s + 2 + D]

    def clip(raw, lo, hi):
        # jnp.clip(raw, lo, hi) == min(max(raw, lo), hi), also when lo > hi.
        return torch.minimum(torch.maximum(raw[None], lo[:, None]), hi[:, None])

    best_cost = best_k = None
    for k, (a, b) in enumerate(LDSP):
        er_raw, ec_raw = o_grid + a, o_grid + b  # (D,)
        er, ec = clip(er_raw, lo_r, hi_r), clip(ec_raw, lo_c, hi_c)  # (C, D)
        sat_r, sat_c = (er != er_raw)[:, :, None], (ec != ec_raw)[:, None, :]
        below_r = (er_raw[None] < lo_r[:, None])[:, :, None]
        below_c = (ec_raw[None] < lo_c[:, None])[:, None, :]
        unsat = vpad[:, a + 2: a + 2 + D, b + 2: b + 2 + D]
        row_val = torch.where(below_r, shift1d(row_lo, b)[:, None, :],
                              shift1d(row_hi, b)[:, None, :])
        col_val = torch.where(below_c, shift1d(col_lo, a)[:, :, None],
                              shift1d(col_hi, a)[:, :, None])
        corner_val = torch.where(below_r, torch.where(below_c, c_ll, c_lh),
                                 torch.where(below_c, c_hl, c_hh))
        cost = torch.where(sat_r & sat_c, corner_val,
                           torch.where(sat_r, row_val, torch.where(sat_c, col_val, unsat)))
        in_volume = (er.abs() <= R)[:, :, None] & (ec.abs() <= R)[:, None, :]
        cost = torch.where(in_volume, cost, _INF)
        if best_cost is None:
            best_cost = cost
            best_k = torch.zeros(cost.shape, dtype=torch.int8, device=dev)
        else:
            take = cost < best_cost  # strict <: the first minimum in LDSP order
            best_cost = torch.where(take, cost, best_cost)
            best_k = torch.where(take, torch.tensor(k, dtype=torch.int8, device=dev), best_k)
    return best_k.reshape(lead + (D * D,))


def _packed_rule(block_size: int) -> bool:
    """Whether the rank map is the packed builder's: wherever the cost*16 +
    rank pack is exact (max DFD bs^2 * 255^2 < 2**24, bs <= 16)."""
    return block_size * block_size * 255 * 255 < 2**24


def _succ_map(volume, origins, H: int, W: int, block_size: int, radius: int) -> torch.Tensor:
    """Rank-map dispatch (JAX bbme.py:819-825): the packed builder where
    `_packed_rule`, else the select chain.  The searches no longer build it
    (`diamond_walk_volume`); it is the rank-map chase's input and the tests'
    reference for the volume chase."""
    if _packed_rule(block_size):
        return _succ_map_packed(volume, origins, H, W, block_size, radius)
    return _succ_map_select(volume, origins, H, W, block_size, radius)


def diamond_walk_volume(
    volume: torch.Tensor, origins: torch.Tensor, H: int, W: int,
    block_size: int, radius: int, max_iters: int = 4096,
    count_mask: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Volume-engine diamond walk: the fixpoint chase, one SDSP pass (JAX
    bbme.py:963-1106).  The chase reads the volume itself and gives what the
    JAX package's chase of its rank map gives (`cuda_kernels.chase_volume`),
    with the rank map's clamp rule of this block size.  Returns the
    (B, nbh, nbw, 2) best absolute positions and the (B,) int32 count of
    walks that visited the volume's boundary-adjacent ring (max |offset| >=
    R - 1), the certificate that a larger radius could not change the result
    when zero.  With a (B, nbh, nbw) bool `count_mask` only its cells count
    (a row band's padding rows do not)."""
    match, og, edge_hits = chase_walk(volume, origins, H, W, block_size, radius, max_iters,
                                      count_mask)
    return sdsp_pass(volume, og, match, H, W, block_size, radius), edge_hits


def chase_walk(
    volume: torch.Tensor, origins: torch.Tensor, H: int, W: int, block_size: int, radius: int,
    max_iters: int = 4096, count_mask: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The large-diamond walk of `diamond_walk_volume` on the volume (the
    chase kernel): the (B, nbh, nbw, 2) fixpoint positions, the origins
    broadcast to them, and the (B,) int32 edge hits."""
    bs, R = block_size, radius
    D = 2 * R + 1
    lead = volume.shape[:-1]
    B = lead[0]
    og = origins.expand(lead + (2,))
    bounds = torch.stack(
        [-og[..., 0], (H - bs - 1) - og[..., 0], -og[..., 1], (W - bs - 1) - og[..., 1]],
        dim=-1,
    ).reshape(-1, 4).to(torch.int32).contiguous()
    o, touched = cuda_kernels.chase_volume(
        volume.reshape(-1, D * D).contiguous(), bounds, D, R, max_iters, _packed_rule(bs)
    )
    o = o.reshape(lead)
    touched = touched.reshape(lead)
    if count_mask is not None:
        touched = touched & count_mask
    edge_hits = touched.reshape(B, -1).sum(dim=1, dtype=torch.int32)
    match = torch.stack([og[..., 0] + o // D - R, og[..., 1] + o % D - R], dim=-1)
    return match, og, edge_hits


def sdsp_pass(volume: torch.Tensor, og: torch.Tensor, match: torch.Tensor, H: int, W: int,
              block_size: int, radius: int) -> torch.Tensor:
    """The single small-diamond pass (reference bbme.py:515-529) through the
    volume around the walk's fixpoints `match`: the best positions."""
    sdsp = _offset_table(SDSP, volume.device)
    pos = _clamped(match[..., None, :] + sdsp, H, W, block_size)
    cost = volume_evaluator(volume, og, radius)(
        pos, torch.ones(pos.shape[:-1], dtype=torch.bool, device=volume.device))
    return _take_best(pos, cost)


def diamond_search(
    previous: torch.Tensor, current: torch.Tensor, pnorm_distance: int = MAE,
    block_size: int = 12, search_window: int = -1, max_iters: int = 4096,
    search_impl: str = "auto", volume_radius: int = 32,
    return_diagnostics: bool = False,
):
    """Large-diamond walk until the centre wins, then one small-diamond pass
    (reference bbme.py:436-534).  Candidate positions are clamped to
    [0, dim - bs - 1] as the reference does.  `search_window` is accepted and
    ignored, as the reference ignores it.  With `return_diagnostics` also
    `{"volume_edge_hits": (B,) int32}` (0 on the unbounded gather engine)."""
    del search_window
    B, H, W = previous.shape
    bs = block_size
    origins = _batched_origins(previous, bs)
    if _resolve_impl(search_impl) == "volume":
        radius = min(volume_radius, max(H, W))
        volume = compute_cost_volume(previous, current, bs, radius, pnorm_distance)
        best, edge_hits = diamond_walk_volume(volume, origins, H, W, bs, radius, max_iters)
    else:
        evaluate = _make_gather_evaluator(previous, current, bs, pnorm_distance)
        best = diamond_walk(evaluate, origins, H, W, bs, max_iters)
        edge_hits = torch.zeros(B, dtype=torch.int32, device=previous.device)
    field = _field(best, origins)
    if return_diagnostics:
        return field, {"volume_edge_hits": edge_hits}
    return field


# ---------------------------------------------------------------------------
# Dispatch (JAX bbme.py:1165-1276, reference bbme.py:12-38, 608-614)
# ---------------------------------------------------------------------------

def get_motion_field(
    previous: torch.Tensor, current: torch.Tensor, block_size: int = 4,
    search_window: int = 2, searching_procedure: int = THREESTEP,
    pnorm_distance: int = MSE, max_iters: int = 4096, search_impl: str = "auto",
    volume_radius: int = 32, return_diagnostics: bool = False,
):
    """(B, H//bs, W//bs, 2) int32 motion field between (B, H, W) uint8 frame
    batches.  Signature and defaults are the JAX package's (reference
    bbme.py:12-19); procedures {0: exhaustive, 1: three-step, 2: 2D-log,
    3: diamond}.  With `return_diagnostics` also
    `{"volume_edge_hits": (B,) int32}`: the volume-engine diamond and 2D-log
    walks a larger radius could have changed; 0 for exhaustive and
    three-step, whose displacement is statically bounded."""
    _resolve_impl(search_impl)
    diag = None
    if searching_procedure == EXHAUSTIVE:
        field = exhaustive_search(previous, current, pnorm_distance, block_size, search_window)
    elif searching_procedure == THREESTEP:
        field = threestep_search(previous, current, pnorm_distance, block_size,
                                 search_window, search_impl)
    elif searching_procedure == TWODLOG:
        field, diag = twodlog_search(previous, current, pnorm_distance, block_size,
                                     search_window, max_iters, search_impl, volume_radius,
                                     return_diagnostics=True)
    elif searching_procedure == DIAMOND:
        field, diag = diamond_search(previous, current, pnorm_distance, block_size,
                                     search_window, max_iters, search_impl, volume_radius,
                                     return_diagnostics=True)
    else:
        raise ValueError(f"unknown searching procedure {searching_procedure}")
    if not return_diagnostics:
        return field
    if diag is None:
        diag = {"volume_edge_hits": torch.zeros(previous.shape[0], dtype=torch.int32,
                                                device=previous.device)}
    return field, diag


def get_motion_field_cfg(previous: torch.Tensor, current: torch.Tensor, cfg: BBMEConfig):
    """`get_motion_field` with every parameter from a `BBMEConfig`."""
    return get_motion_field(
        previous, current, cfg.block_size, cfg.search_window, cfg.searching_procedure,
        cfg.pnorm_distance, cfg.max_search_iters, cfg.search_impl, cfg.volume_radius,
    )


# The JAX package's compiled dispatch (JAX bbme.py:1229-1262): one captured
# CUDA graph per (static arguments, shapes, device) on the card; the loops
# of 2D-log and the gather diamond are WHILE nodes inside it.
get_motion_field_jit = compiled(get_motion_field, static_argnames=(
    "block_size", "search_window", "searching_procedure", "pnorm_distance", "max_iters",
    "search_impl", "volume_radius", "return_diagnostics"))
