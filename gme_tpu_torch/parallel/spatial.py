"""Spatial (row-band) parallelism with halo exchange, running the full
per-pair step.

Counterpart of `gme_tpu/parallel/spatial.py`.  A frame's rows split into
`space` equal bands, and the whole hierarchical robust GME (reference
motion.py:109-136) runs on the bands:

- the Gaussian pyramid is built on the bands, with a 2-row halo exchange a
  level and cv2.pyrDown's REFLECT_101 border at the frame's top and bottom
  only, equal to the full-frame `ops.pyramid.pyrdown`;
- each band builds the cost volume of the block rows whose origin lies in
  it, from its previous-frame rows and the current frame's rows within the
  search radius (halos, several bands deep where a band is thinner than
  the radius), and walks it with global coordinates;
- the outlier threshold sorts the all-gathered error grid, the affine fit
  sums exact integer moments over the bands, the PSNR sums exact integer
  SSEs: the parameters, every integer output and the PSNR equal the
  single-device step's;
- compensation runs per band against the all-gathered previous frame.

Where the JAX package runs this as one SPMD program under `shard_map`, the
port runs it in one process, in lockstep over the bands: each band is a
(B, lh, W) uint8 tensor on its slot's device, and the collectives
(`extend_rows`' neighbour rows, `psum`, `all_gather`, `broadcast`,
`scatter_rows`, `gather`) are functions of the whole list of bands.  They
are the only places where a tensor moves between devices, each through one
`utils.compiled.transfer`.  The bands that share a device are stacked into
the pair dimension for the volume kernels and the chase (`_by_device`);
every band has the same (Tmax*bs, nbw*bs) shape (`_band_tmax`), so a level
is one launch of each kernel per device, as in the single-device step.

The JAX package jits its sharded step.  Here the lockstep program
(`spatial_program`) is compiled (`utils.compiled`): where every slot of the
mesh names one device, as on one card, into one CUDA graph per mesh,
config, frame shape and device (`spatial_program_jit`); across devices into
a chain of per-device graphs split at the collectives, each collective a
step of copies between them (`spatial_program_segmented`).  The program
reads nothing back to the host and makes no tensor from host data.
`make_spatial_pipeline_eager` runs it op by op.

The searches use the volume engine, as in the JAX package; compare with a
single-device step under `search_impl="volume"`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gme_tpu_torch.config import DIAMOND, EXHAUSTIVE, THREESTEP, GMEConfig
from gme_tpu_torch.ops.affine import (
    get_motion_field_affine,
    int_moments,
    moments_fit_ok,
    parameter_projection,
    params_from_moments,
)
from gme_tpu_torch.ops.bbme import (
    _INF,
    _block_grid,
    _dfd_cost_volume,
    _field,
    _offset_mask,
    compute_cost_volume_band,
    diamond_walk_volume,
    threestep_search_radius,
    threestep_walk,
    volume_evaluator,
)
from gme_tpu_torch.ops.metrics import frame_difference, psnr_from_sse, sse
from gme_tpu_torch.ops.pyramid import _taps_stride2
from gme_tpu_torch.parallel.mesh import SPACE_AXIS, Mesh
from gme_tpu_torch.utils.compiled import compiled, transfer

Bands = List[torch.Tensor]  # S tensors (B, rows, ...), band k on its slot's device


# ---------------------------------------------------------------------------
# Collectives over the list of bands
# ---------------------------------------------------------------------------

def _exchange(specs: Sequence[Tuple[Bands, int, int]]) -> List[Bands]:
    """`extend_rows` of several band lists, [(bands, top, bottom), ...], in
    one transfer."""
    moves, plans = [], []
    for bands, top, bottom in specs:
        S = len(bands)
        lh = bands[0].shape[1]
        plan = []
        for k, x in enumerate(bands):
            parts = []

            def rows(j, sl):
                if 0 <= j < S:
                    moves.append((bands[j][:, sl], x.device))
                    return len(moves) - 1  # the index of its moved rows
                n = len(range(*sl.indices(lh)))
                return x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))

            for h in range(-(-top // lh) if top > 0 else 0, 0, -1):  # farthest first
                take = min(top - (h - 1) * lh, lh)
                parts.append(rows(k - h, slice(lh - take, lh)))
            parts.append(x)
            for h in range(1, (-(-bottom // lh) if bottom > 0 else 0) + 1):
                take = min(bottom - (h - 1) * lh, lh)
                parts.append(rows(k + h, slice(0, take)))
            plan.append(parts)
        plans.append(plan)
    moved = transfer(moves)
    return [[torch.cat([moved[p] if isinstance(p, int) else p for p in parts], dim=1)
             if len(parts) > 1 else parts[0] for parts in plan] for plan in plans]


def extend_rows(bands: Bands, top: int, bottom: int) -> Bands:
    """Each band with `top` rows of the bands above it and `bottom` rows of
    the bands below it (the multi-hop `ppermute` of JAX spatial.py:74-103:
    a halo wider than a band takes rows from farther bands).  Rows beyond
    the frame are zeros; callers mask them."""
    return _exchange([(bands, top, bottom)])[0]


def psum(parts: Sequence) -> object:
    """The sum of the bands' tensors, or of each tuple of tensors as
    `lax.psum` sums a tree, on the first band's device (every band reads the
    same value; integer sums are exact in any order)."""
    tree = isinstance(parts[0], tuple)
    rows = [p if tree else (p,) for p in parts]
    moved = iter(transfer([(t, rows[0][0].device) for r in rows[1:] for t in r]))
    totals = list(rows[0])
    for _ in rows[1:]:
        totals = [t + next(moved) for t in totals]
    return tuple(totals) if tree else totals[0]


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The bands' tensors concatenated along `dim`, on each of `devices`."""
    moved = transfer([(p, d) for d in devices for p in parts])
    n = len(parts)
    return [torch.cat(moved[i * n:(i + 1) * n], dim=dim) for i in range(len(devices))]


def broadcast(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`value` on each of `devices`."""
    return transfer([(value, d) for d in devices])


def scatter_rows(frames: Sequence[torch.Tensor], devices: Sequence[torch.device],
                 starts: Sequence[int], rows: int) -> List[Bands]:
    """Of each (B, H, ...) frame, rows [starts[k], starts[k] + rows) on
    devices[k]: one band list a frame."""
    moved = transfer([(f[:, s:s + rows], d) for f in frames for s, d in zip(starts, devices)])
    n = len(devices)
    return [moved[i * n:(i + 1) * n] for i in range(len(frames))]


def gather(out: Dict[str, object], device: torch.device) -> Dict[str, torch.Tensor]:
    """A step's outputs on `device`: each list of bands concatenated along
    the rows, every other value moved there."""
    leaves = [t for v in out.values() for t in (v if isinstance(v, list) else [v])]
    moved = iter(transfer([(t, device) for t in leaves]))
    got = {}
    for k, v in out.items():
        got[k] = torch.cat([next(moved) for _ in v], dim=1) if isinstance(v, list) else next(moved)
    return got


# The functions above are the only ones that move tensors between devices
# (tests/test_torch_compiled.py reads this module to hold it so): there a
# split capture of the band program ends its per-device graphs.
COLLECTIVES = ("_exchange", "extend_rows", "psum", "all_gather", "broadcast", "scatter_rows",
               "gather")


def _by_device(bands: Bands) -> List[List[int]]:
    """The band indices grouped by device, in band order."""
    groups: Dict[torch.device, List[int]] = {}
    for k, b in enumerate(bands):
        groups.setdefault(b.device, []).append(k)
    return list(groups.values())


def _unstack(t: torch.Tensor, ks: List[int], out: list) -> None:
    """Split a tensor stacked over the bands `ks` (leading dim
    len(ks) * B) back into `out[k]`."""
    for i, part in enumerate(t.reshape((len(ks), -1) + tuple(t.shape[1:]))):
        out[ks[i]] = part


# ---------------------------------------------------------------------------
# Gaussian pyramid on row bands
# ---------------------------------------------------------------------------

def _pyrdown_band(bands: Bands) -> Bands:
    """One cv2.pyrDown level on the row bands: a 2-row halo exchange, and
    REFLECT_101 at the frame's top and bottom only (JAX spatial.py:109-131).
    Band heights must be even (`validate_spatial_shapes`)."""
    S = len(bands)
    lh, W = bands[0].shape[1:]
    x = [b.float() for b in bands]
    ext = extend_rows(x, 2, 2)  # (B, lh + 4, W)
    out = []
    for k in range(S):
        e = ext[k]
        if k == 0:  # rows -2, -1 -> 2, 1
            e = torch.cat([x[k][:, 2:3], x[k][:, 1:2], e[:, 2:]], dim=1)
        if k == S - 1:  # rows H, H + 1 -> H - 2, H - 3
            e = torch.cat([e[:, :lh + 2], x[k][:, lh - 2:lh - 1], x[k][:, lh - 3:lh - 2]], dim=1)
        e = F.pad(e, (2, 2), mode="reflect")  # columns: numpy's "reflect"
        acc = _taps_stride2(_taps_stride2(e, 1, lh // 2), 2, (W + 1) // 2)
        out.append(torch.floor((acc + 128.0) * (1.0 / 256.0)).byte())
    return out


def _pyramids_band(bands: Bands, levels: int) -> List[Bands]:
    """Banded Gaussian pyramid, coarsest first (reference utils.py:34-51)."""
    pyramid = [bands]
    curr = bands
    for _ in range(1, levels):
        curr = _pyrdown_band(curr)
        pyramid.insert(0, curr)
    return pyramid


# ---------------------------------------------------------------------------
# Banded block matching
# ---------------------------------------------------------------------------

def _band_rows(k: int, lh: int, H: int, bs: int) -> Tuple[int, int]:
    """Block rows [gb0, gb1) owned by band k: those whose origin lies in
    its pixel rows."""
    return -(-(k * lh) // bs), min(-(-((k + 1) * lh) // bs), H // bs)


def _band_origins(gb0s: List[int], device) -> torch.Tensor:
    """(len(gb0s),) int32 first block rows of bands, filled on `device`:
    a tensor built from a host list would be a copy from the host, which a
    CUDA graph capture cannot hold."""
    return torch.cat([torch.full((1,), g, dtype=torch.int32, device=device) for g in gb0s])


def _band_tmax(H: int, space: int, bs: int) -> int:
    """Most block rows owned by any band."""
    lh = H // space
    return max(max(b - a, 0) for a, b in (_band_rows(k, lh, H, bs) for k in range(space)))


def _band_blocks(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                 above: int, below: int, right: int):
    """Each band's volume inputs (JAX spatial.py:163-210, 326-347): the
    previous-frame rows [gb0*bs, (gb0+Tmax)*bs), cropped to whole blocks,
    and the current-frame rows [gb0*bs - above, (gb0+Tmax)*bs + below),
    columns padded by `above` on the left and cropped to nbw*bs + above +
    right, uint8 with zeros beyond the frame.  Returns (prev, curr, gb0,
    valid) lists; valid (Tmax,) bool marks the owned block rows."""
    S = len(prev_bands)
    lh = prev_bands[0].shape[1]
    nbh, nbw = _block_grid(H, W, bs)
    Tmax = _band_tmax(H, S, bs)
    ext_b = max(0, Tmax * bs + bs - 1 - lh)
    prev_ext, curr_ext = _exchange([([p[:, :, : nbw * bs] for p in prev_bands], 0, ext_b),
                                    (curr_bands, above, ext_b + below)])
    prev_blk, curr_blk, gb0s, valid = [], [], [], []
    for k in range(S):
        gb0, gb1 = _band_rows(k, lh, H, bs)
        start = gb0 * bs - k * lh  # in [0, bs)
        prev_blk.append(prev_ext[k][:, start:start + Tmax * bs])
        c = F.pad(curr_ext[k], (above, right))[:, :, : nbw * bs + above + right]
        curr_blk.append(c[:, start:start + Tmax * bs + above + below])
        gb0s.append(gb0)
        valid.append(gb0 + torch.arange(Tmax, device=prev_bands[k].device) < gb1)
    return prev_blk, curr_blk, gb0s, valid


def _stacked_origins(gb0: torch.Tensor, B: int, Tmax: int, nbw: int, bs: int) -> torch.Tensor:
    """(len(gb0) * B, Tmax, nbw, 2) int32 global block origins of stacked
    bands whose first block rows are `gb0`."""
    gi = (gb0[:, None] + torch.arange(Tmax, dtype=torch.int32, device=gb0.device)) * bs
    gj = torch.arange(nbw, dtype=torch.int32, device=gb0.device) * bs
    og = torch.stack(torch.broadcast_tensors(gi[:, :, None], gj[None, None, :]), dim=-1)
    return og[:, None].expand(-1, B, -1, -1, -1).reshape(-1, Tmax, nbw, 2)


def _banded_volume(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int, R: int,
                   pnorm: int):
    """The masked banded cost volumes of the diamond and three-step walks
    (JAX spatial.py:163-217), one `compute_cost_volume_band` per device on
    the stacked bands.  Yields (ks, volume (len(ks)*B, Tmax, nbw, D*D),
    origins (len(ks)*B, Tmax, nbw, 2)) per device, and returns with the
    per-band gb0 and valid lists."""
    prev_blk, curr_blk, gb0s, valid = _band_blocks(prev_bands, curr_bands, H, W, bs, R, R, R)
    B = prev_bands[0].shape[0]
    Tmax, nbw = prev_blk[0].shape[1] // bs, prev_blk[0].shape[2] // bs
    groups = []
    for ks in _by_device(prev_bands):
        dev = prev_bands[ks[0]].device
        gb0 = _band_origins([gb0s[k] for k in ks], dev)
        vol = compute_cost_volume_band(
            torch.cat([prev_blk[k] for k in ks]).contiguous(),
            torch.cat([curr_blk[k] for k in ks]).contiguous(),
            gb0[:, None].expand(-1, B).reshape(-1), (H, W), bs, R, pnorm,
        )
        groups.append((ks, vol, _stacked_origins(gb0, B, Tmax, nbw, bs)))
    return groups, gb0s, valid


def banded_diamond_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                         radius: int, pnorm: int, max_iters: int):
    """Diamond-search field of each band's block rows: (field list of
    (B, Tmax, nbw, 2) int32, valid list of (Tmax,) bool, gb0 list, edge-hit
    list of (B,) int32 counting the owned rows only).  Walk semantics of the
    single-device volume-engine `diamond_search`."""
    groups, gb0s, valid = _banded_volume(prev_bands, curr_bands, H, W, bs, radius, pnorm)
    S = len(prev_bands)
    field, hits = [None] * S, [None] * S
    for ks, vol, origins in groups:
        count = torch.cat([valid[k] for k in ks]).reshape(len(ks), 1, -1, 1)
        count = count.expand(len(ks), vol.shape[0] // len(ks), -1, origins.shape[2])
        best, edge = diamond_walk_volume(vol, origins, H, W, bs, radius, max_iters,
                                         count_mask=count.reshape(origins.shape[:3]))
        _unstack(_field(best, origins), ks, field)
        _unstack(edge, ks, hits)
    return field, valid, gb0s, hits


def banded_threestep_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                           sw: int, pnorm: int):
    """Three-step field of each band's block rows: the banded volume at
    three-step's exact radius and the single-device rounds
    (`ops.bbme.threestep_walk`) on global coordinates; the contract of
    `banded_diamond_field`, edge hits 0."""
    R = threestep_search_radius(bs, sw)
    groups, gb0s, valid = _banded_volume(prev_bands, curr_bands, H, W, bs, R, pnorm)
    field = [None] * len(prev_bands)
    for ks, vol, origins in groups:
        d = threestep_walk(volume_evaluator(vol, origins, R), origins, H, W, bs, sw)
        _unstack(torch.stack([d[..., 1], d[..., 0]], dim=-1).int(), ks, field)
    return field, valid, gb0s, _no_hits(prev_bands)


def banded_exhaustive_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                            sw: int, pnorm: int):
    """Exhaustive field of each band's block rows: the band's volume over
    the window range(-sw, sw + bs) and a masked first-minimum argmin, column
    offset outer (JAX spatial.py:293-380, reference bbme.py:105-179); the
    contract of `banded_diamond_field`, edge hits 0."""
    D = 2 * sw + bs
    prev_blk, curr_blk, gb0s, valid = _band_blocks(prev_bands, curr_bands, H, W, bs,
                                                   sw, sw + bs - 1, sw + bs - 1)
    B = prev_bands[0].shape[0]
    Tmax, nbw = prev_blk[0].shape[1] // bs, prev_blk[0].shape[2] // bs
    field = [None] * len(prev_bands)
    for ks in _by_device(prev_bands):
        dev = prev_bands[ks[0]].device
        vol = _dfd_cost_volume(torch.cat([prev_blk[k] for k in ks]).contiguous(),
                               torch.cat([curr_blk[k] for k in ks]).contiguous(), bs, D, pnorm)
        offsets = torch.arange(-sw, sw + bs, dtype=torch.int32, device=dev)
        gb0 = _band_origins([gb0s[k] for k in ks], dev)
        row = ((gb0[:, None] + torch.arange(Tmax, dtype=torch.int32, device=dev)) * bs)[..., None]
        valid_r = (row + offsets >= 0) & (row + offsets <= H - bs)  # (len(ks), Tmax, D_wr)
        valid_c = _offset_mask(nbw, bs, W, offsets)  # (nbw, D_wc)
        mask = valid_r[:, None, :, None, None, :] & valid_c[None, None, None, :, :, None]
        cost = vol.reshape(len(ks), B, Tmax, nbw, D, D).transpose(-1, -2)  # (.., D_wc, D_wr)
        cost = cost.masked_fill(~mask, _INF).reshape(len(ks) * B, Tmax, nbw, D * D)
        kk = torch.argmin(cost, dim=-1)  # first minimum == the reference's scan order
        _unstack(torch.stack([offsets[kk // D], offsets[kk % D]], dim=-1), ks, field)
    return field, valid, gb0s, _no_hits(prev_bands)


def _no_hits(bands: Bands) -> List[torch.Tensor]:
    return [torch.zeros(b.shape[0], dtype=torch.int32, device=b.device) for b in bands]


def _banded_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int, radius: int,
                  cfg: GMEConfig):
    """Search-procedure dispatch for the banded field (diamond, the GME
    default; exhaustive and three-step at `cfg.search_window`)."""
    if cfg.searching_procedure == DIAMOND:
        return banded_diamond_field(prev_bands, curr_bands, H, W, bs, radius,
                                    cfg.pnorm_distance, cfg.max_search_iters)
    if cfg.searching_procedure == EXHAUSTIVE:
        return banded_exhaustive_field(prev_bands, curr_bands, H, W, bs, cfg.search_window,
                                       cfg.pnorm_distance)
    if cfg.searching_procedure == THREESTEP:
        return banded_threestep_field(prev_bands, curr_bands, H, W, bs, cfg.search_window,
                                      cfg.pnorm_distance)
    raise ValueError(
        "spatially-sharded pipeline supports diamond, exhaustive and three-step search"
    )


# ---------------------------------------------------------------------------
# Distributed affine fit
# ---------------------------------------------------------------------------

def _first_params_psum(fields: Bands, valid: List[torch.Tensor]) -> torch.Tensor:
    """Translation-only init: a0, b0 = the mean of the dense field over the
    owned cells (reference motion.py:160-188), the sums psum'd and divided
    as JAX spatial.py:396-413 divides them.  (B, 6) float32."""
    parts = []
    for f, v in zip(fields, valid):
        m = v[:, None].long()
        n = (m.sum() * f.shape[2]).expand(f.shape[0])
        parts.append(torch.stack([(f[..., 0].long() * m).sum(dim=(1, 2)),
                                  (f[..., 1].long() * m).sum(dim=(1, 2)), n], dim=1))
    sums = psum(parts).float()
    a0 = sums[:, 0] / sums[:, 2]
    b0 = sums[:, 1] / sums[:, 2]
    z = torch.zeros_like(a0)
    return torch.stack([a0, z, z, b0, z, z], dim=1)


def _fit_psum(fields: Bands, inliers: Bands, gb0s: List[int], coord_stride: int) -> torch.Tensor:
    """Distributed least-squares affine fit: each band's exact integer
    moments with global block rows, one psum, the single-device solve, so
    the parameters equal `fit_normal_equations`' (JAX spatial.py:416-437)."""
    moments = psum([int_moments(f, m, coord_stride, row0=g)
                    for f, m, g in zip(fields, inliers, gb0s)])
    return params_from_moments(moments)


def _outlier_inliers(fields: Bands, affine_bands: Bands, valid: List[torch.Tensor],
                     outlier_fraction: float, n_cells: int) -> Bands:
    """Distributed outlier rejection (reference motion.py:236-244): the
    per-cell L1 errors of every band, +inf in padding rows, all-gathered and
    sorted per pair, the threshold at `(n - int(f*n)) % n` as in JAX
    spatial.py:440-463.  Returns each band's INLIER mask."""
    diffs = [(f.int() - a.int()).abs().sum(dim=-1) for f, a in zip(fields, affine_bands)]
    errs = [torch.where(v[:, None], d.float(), float("inf")) for d, v in zip(diffs, valid)]
    (gathered,) = all_gather(errs, 1, [errs[0].device])  # (B, S*Tmax, nbw)
    flat = torch.sort(gathered.reshape(gathered.shape[0], -1), dim=1).values
    threshold = flat[:, (n_cells - int(outlier_fraction * n_cells)) % n_cells]
    on = dict(zip(_devices(diffs), broadcast(threshold, _devices(diffs))))
    return [~(d.float() > on[d.device][:, None, None]) for d in diffs]


def _devices(bands: Bands) -> List[torch.device]:
    """The bands' devices, each once, in band order."""
    return list(dict.fromkeys(b.device for b in bands))


def _affine_bands(full: torch.Tensor, Tmax: int, gb0s: List[int], bands: Bands) -> Bands:
    """Rows [gb0, gb0+Tmax) of the dense affine field `full`
    (B, nbh, nbw, 2), zero past its last row, on each band's device."""
    padded = torch.cat([full, full.new_zeros((full.shape[0], Tmax) + tuple(full.shape[2:]))], 1)
    (aff,) = scatter_rows([padded], [b.device for b in bands], gb0s, Tmax)
    return aff


# ---------------------------------------------------------------------------
# The spatially-sharded per-pair step
# ---------------------------------------------------------------------------

def spatial_gme_step(prev_bands: Bands, curr_bands: Bands, cfg: GMEConfig, H: int,
                     W: int) -> Dict[str, object]:
    """One full pipeline step on the row bands of (B, H, W) uint8 frames
    (JAX spatial.py:470-585): pyramid, dense init, per-level robust re-fit,
    dense affine field, compensation, differences, PSNR.  The band-sharded
    outputs ("compensated", "diff_curr_prev", "diff_curr_comp") are lists
    of (B, lh, W) bands; the others are the replicated values, on the first
    band's device."""
    levels = cfg.pyramid_levels
    Hs, Ws = [H], [W]
    for _ in range(1, levels):
        Hs.insert(0, Hs[0] // 2)
        Ws.insert(0, (Ws[0] + 1) // 2)

    prev_pyr = _pyramids_band(prev_bands, levels)
    curr_pyr = _pyramids_band(curr_bands, levels)

    dense_field, dvalid, _, edge_hits = _banded_field(
        prev_pyr[0], curr_pyr[0], Hs[0], Ws[0], cfg.dense_block_size,
        cfg.dense_volume_radius, cfg,
    )
    parameters = _first_params_psum(dense_field, dvalid)

    for i in range(1, levels):
        parameters = parameter_projection(parameters)
        nbh, nbw = _block_grid(Hs[i], Ws[i], cfg.block_size)
        field, valid, gb0s, ehits = _banded_field(
            prev_pyr[i], curr_pyr[i], Hs[i], Ws[i], cfg.block_size, cfg.volume_radius, cfg,
        )
        edge_hits = [a + b for a, b in zip(edge_hits, ehits)]
        Tmax = field[0].shape[1]
        full = get_motion_field_affine((nbh, nbw), parameters)
        aff = _affine_bands(full, Tmax, gb0s, field)
        inlier = _outlier_inliers(field, aff, valid, cfg.outlier_fraction, nbh * nbw)
        parameters = _fit_psum(field, [m & v[:, None] for m, v in zip(inlier, valid)], gb0s,
                               cfg.coord_stride)

    nbh_f, nbw_f = _block_grid(H, W, cfg.block_size)
    model_motion_field = get_motion_field_affine((nbh_f, nbw_f), parameters)

    # Compensation of each band against the all-gathered previous frame
    # (reference motion.py:289-321: uncovered and out-of-frame pixels keep
    # the original value).
    lh = prev_bands[0].shape[1]
    warp_bs = H // nbh_f  # reference motion.py:303 derives bs from the ratio
    devs = _devices(prev_bands)
    # The broadcast first: its transfer and the gather's are one step.
    field_on = dict(zip(devs, broadcast(model_motion_field, devs)))
    prev_full = dict(zip(devs, all_gather(prev_bands, 1, devs)))
    compensated, sses = [], []
    for k, (p, c) in enumerate(zip(prev_bands, curr_bands)):
        dev = p.device
        B = p.shape[0]
        rr = k * lh + torch.arange(lh, dtype=torch.int32, device=dev)[:, None]
        cc = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        d = field_on[dev].int()
        d_px = d[:, (rr // warp_bs).clamp(0, nbh_f - 1).long(),
                 (cc // warp_bs).clamp(0, nbw_f - 1).long()]  # (B, lh, W, 2)
        covered = (rr < nbh_f * warp_bs) & (cc < nbw_f * warp_bs)
        src_r = rr - d_px[..., 1]
        src_c = cc - d_px[..., 0]
        ok = covered & (src_r >= 0) & (src_c >= 0) & (src_r < H) & (src_c < W)
        idx = src_r.clamp(0, H - 1) * W + src_c.clamp(0, W - 1)
        warped = prev_full[dev].reshape(B, H * W).gather(1, idx.reshape(B, -1).long())
        warped = warped.reshape(B, lh, W)
        comp = torch.where(ok, warped, p)
        compensated.append(comp)
        sses.append(sse(c, comp))

    # The bands' edge-hit counts are disjoint: each counts its owned rows only.
    sse_total, hits = psum(list(zip(sses, edge_hits)))
    return {
        "parameters": parameters,
        "model_motion_field": model_motion_field,
        "compensated": compensated,
        "diff_curr_prev": [frame_difference(c, p) for p, c in zip(prev_bands, curr_bands)],
        "diff_curr_comp": [frame_difference(c, m) for m, c in zip(compensated, curr_bands)],
        "psnr": psnr_from_sse(sse_total, H * W),
        "volume_edge_hits": hits,
    }


def validate_spatial_shapes(H: int, space: int, cfg: GMEConfig, W: int | None = None) -> None:
    """Shape constraints of the spatially-sharded pipeline (the JAX
    package's, with its messages)."""
    div = space * 2 ** (cfg.pyramid_levels - 1)
    if H % div:
        raise ValueError(
            f"H={H} must be divisible by space * 2**(levels-1) = {div} "
            f"for the spatially-sharded pipeline"
        )
    if H // (space * 2 ** (cfg.pyramid_levels - 1)) < 4:
        raise ValueError(
            f"coarsest-level bands need >= 4 rows "
            f"(H={H}, space={space}, levels={cfg.pyramid_levels})"
        )
    if cfg.searching_procedure not in (DIAMOND, EXHAUSTIVE, THREESTEP):
        raise ValueError(
            "the spatially-sharded pipeline implements diamond (the GME "
            "default, reference motion.py:29,50,229), exhaustive and "
            "three-step search; 2D-log's walk is unbounded within frame "
            "clamps (reference bbme.py:381) so its halo width has no "
            "static bound — single-device only"
        )
    if W is not None:
        nbh, nbw = _block_grid(H, W, cfg.block_size)
        if not moments_fit_ok(nbh, nbw, (H, W), cfg.coord_stride):
            raise ValueError(
                f"frame {H}x{W} exceeds the exact int32 moment bound of the "
                "distributed affine fit (moments_fit_ok); use the "
                "single-device pipeline or a larger block size"
            )


def spatial_program(prev: torch.Tensor, curr: torch.Tensor,
                    devices: Tuple[Tuple[torch.device, ...], ...], cfg: GMEConfig, H: int,
                    W: int) -> Dict[str, torch.Tensor]:
    """The lockstep program of a (data, space) mesh whose slots are
    `devices` (`Mesh.devices`): the (B, H, W) uint8 batch split into data
    shards of pairs and bands of rows, `spatial_gme_step` on each shard,
    and the dict of `gme_pipeline_batch` gathered on the first slot's
    device.  B must be a multiple of the data size."""
    lh = H // len(devices[0])
    out_dev = devices[0][0]
    n = prev.shape[0] // len(devices)
    shards = [scatter_rows((prev[d * n:(d + 1) * n], curr[d * n:(d + 1) * n]), slots,
                           [s * lh for s in range(len(slots))], lh)
              for d, slots in enumerate(devices)]
    outs = [gather(spatial_gme_step(p, c, cfg, H, W), out_dev) for p, c in shards]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


# The JAX package's `jax.jit(sharded)` (JAX spatial.py:624-658): one
# captured CUDA graph per (mesh, cfg, H, W, frame shape, device) where every
# slot names one device ...
spatial_program_jit = compiled(spatial_program, static_argnames=("devices", "cfg", "H", "W"))
# ... and, across devices, a chain of per-device graphs split at the
# collectives (`utils.compiled`, split=True).  On one device it is called
# by name, to hold the split to the single graph.
spatial_program_segmented = compiled(spatial_program, static_argnames=("devices", "cfg", "H", "W"),
                                     split=True)


def _check_batch(mesh: Mesh, B: int) -> None:
    if B % len(mesh.devices):
        raise ValueError(f"batch {B} must divide by mesh data={len(mesh.devices)}")


def make_spatial_pipeline_eager(mesh: Mesh, cfg: GMEConfig, H: int, W: int):
    """The fully sharded step run op by op: pairs over "data", frame rows
    over "space".  Returns step(prev, curr) for (B, H, W) uint8 batches, B
    a multiple of the data size, giving the dict of `gme_pipeline_batch`
    (without the bands) on the first slot's device."""
    validate_spatial_shapes(H, mesh.shape[SPACE_AXIS], cfg, W)

    def step(prev: torch.Tensor, curr: torch.Tensor) -> Dict[str, torch.Tensor]:
        _check_batch(mesh, prev.shape[0])
        return spatial_program(prev, curr, mesh.devices, cfg, H, W)

    return step


def _program_for(mesh: Mesh):
    """The compiled band program of a mesh: one graph where every slot
    names one device, else the segmented program."""
    slots = {dev for row in mesh.devices for dev in row}
    return spatial_program_jit if len(slots) == 1 else spatial_program_segmented


def make_spatial_pipeline(mesh: Mesh, cfg: GMEConfig, H: int, W: int):
    """The fully sharded step, the contract of `make_spatial_pipeline_eager`,
    compiled (`_program_for`; on the CPU the program itself runs).  The
    frames go to the first slot's device first."""
    validate_spatial_shapes(H, mesh.shape[SPACE_AXIS], cfg, W)
    program = _program_for(mesh)
    dev = mesh.devices[0][0]

    def step(prev: torch.Tensor, curr: torch.Tensor) -> Dict[str, torch.Tensor]:
        _check_batch(mesh, prev.shape[0])
        prev, curr = (broadcast(x, [dev])[0] for x in (prev, curr))
        return program(prev, curr, mesh.devices, cfg, H, W)

    return step
