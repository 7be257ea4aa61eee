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
(B, lh, W) uint8 tensor on its slot's device, and the three collectives
(`extend_rows`' neighbour rows, `psum`, `all_gather`) are functions of the
whole list of bands.  The bands that share a device are stacked into the
pair dimension for the volume kernels and the chase (`_by_device`); every
band has the same (Tmax*bs, nbw*bs) shape (`_band_tmax`), so a level is one
launch of each kernel per device, as in the single-device step.

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

Bands = List[torch.Tensor]  # S tensors (B, rows, ...), band k on its slot's device


# ---------------------------------------------------------------------------
# Collectives over the list of bands
# ---------------------------------------------------------------------------

def extend_rows(bands: Bands, top: int, bottom: int) -> Bands:
    """Each band with `top` rows of the bands above it and `bottom` rows of
    the bands below it (the multi-hop `ppermute` of JAX spatial.py:74-103:
    a halo wider than a band takes rows from farther bands).  Rows beyond
    the frame are zeros; callers mask them."""
    S = len(bands)
    lh = bands[0].shape[1]
    out = []
    for k, x in enumerate(bands):
        parts = []

        def rows(j, sl):
            if 0 <= j < S:
                return bands[j][:, sl].to(x.device)
            n = len(range(*sl.indices(lh)))
            return x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))

        for h in range(-(-top // lh) if top > 0 else 0, 0, -1):  # farthest first
            take = min(top - (h - 1) * lh, lh)
            parts.append(rows(k - h, slice(lh - take, lh)))
        parts.append(x)
        for h in range(1, (-(-bottom // lh) if bottom > 0 else 0) + 1):
            take = min(bottom - (h - 1) * lh, lh)
            parts.append(rows(k + h, slice(0, take)))
        out.append(torch.cat(parts, dim=1) if len(parts) > 1 else x)
    return out


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the bands' tensors, on the first band's device (every
    band reads the same value; integer sums are exact in any order)."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The bands' tensors concatenated along `dim`, on the first band's
    device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


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
    x = [b.to(torch.float32) for b in bands]
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
        out.append(torch.floor((acc + 128.0) * (1.0 / 256.0)).to(torch.uint8))
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
    prev_ext = extend_rows([p[:, :, : nbw * bs] for p in prev_bands], 0, ext_b)
    curr_ext = extend_rows(curr_bands, above, ext_b + below)
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
    return og.repeat_interleave(B, dim=0)


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
        gb0 = torch.tensor([gb0s[k] for k in ks], dtype=torch.int32, device=dev)
        vol = compute_cost_volume_band(
            torch.cat([prev_blk[k] for k in ks]).contiguous(),
            torch.cat([curr_blk[k] for k in ks]).contiguous(),
            gb0.repeat_interleave(B), (H, W), bs, R, pnorm,
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
        _unstack(torch.stack([d[..., 1], d[..., 0]], dim=-1).to(torch.int32), ks, field)
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
        gb0 = torch.tensor([gb0s[k] for k in ks], dtype=torch.int32, device=dev)
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
        m = v[:, None].to(torch.int64)
        n = (m.sum() * f.shape[2]).expand(f.shape[0])
        parts.append(torch.stack([(f[..., 0].to(torch.int64) * m).sum(dim=(1, 2)),
                                  (f[..., 1].to(torch.int64) * m).sum(dim=(1, 2)), n], dim=1))
    sums = psum(parts).to(torch.float32)
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
    diffs = [(f.to(torch.int32) - a.to(torch.int32)).abs().sum(dim=-1)
             for f, a in zip(fields, affine_bands)]
    errs = [torch.where(v[:, None], d.to(torch.float32), float("inf"))
            for d, v in zip(diffs, valid)]
    gathered = all_gather(errs, dim=1)  # (B, S*Tmax, nbw)
    flat = torch.sort(gathered.reshape(gathered.shape[0], -1), dim=1).values
    threshold = flat[:, (n_cells - int(outlier_fraction * n_cells)) % n_cells]
    return [~(d.to(torch.float32) > threshold.to(d.device)[:, None, None]) for d in diffs]


def _affine_band(full: torch.Tensor, Tmax: int, gb0: int, device) -> torch.Tensor:
    """Rows [gb0, gb0+Tmax) of the dense affine field `full`
    (B, nbh, nbw, 2), zero past its last row."""
    padded = torch.cat([full, full.new_zeros((full.shape[0], Tmax) + tuple(full.shape[2:]))], 1)
    return padded[:, gb0:gb0 + Tmax].to(device)


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
        aff = [_affine_band(full, Tmax, g, f.device) for f, g in zip(field, gb0s)]
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
    compensated, sses, prev_full = [], [], {}
    for k, (p, c) in enumerate(zip(prev_bands, curr_bands)):
        dev = p.device
        B = p.shape[0]
        if dev not in prev_full:
            prev_full[dev] = all_gather([b.to(dev) for b in prev_bands], dim=1).reshape(B, H * W)
        rr = k * lh + torch.arange(lh, dtype=torch.int32, device=dev)[:, None]
        cc = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        d = model_motion_field.to(device=dev, dtype=torch.int32)
        d_px = d[:, (rr // warp_bs).clamp(0, nbh_f - 1).long(),
                 (cc // warp_bs).clamp(0, nbw_f - 1).long()]  # (B, lh, W, 2)
        covered = (rr < nbh_f * warp_bs) & (cc < nbw_f * warp_bs)
        src_r = rr - d_px[..., 1]
        src_c = cc - d_px[..., 0]
        ok = covered & (src_r >= 0) & (src_c >= 0) & (src_r < H) & (src_c < W)
        idx = src_r.clamp(0, H - 1) * W + src_c.clamp(0, W - 1)
        warped = prev_full[dev].gather(1, idx.reshape(B, -1).long()).reshape(B, lh, W)
        comp = torch.where(ok, warped, p)
        compensated.append(comp)
        sses.append(sse(c, comp))

    return {
        "parameters": parameters,
        "model_motion_field": model_motion_field,
        "compensated": compensated,
        "diff_curr_prev": [frame_difference(c, p) for p, c in zip(prev_bands, curr_bands)],
        "diff_curr_comp": [frame_difference(c, m) for m, c in zip(compensated, curr_bands)],
        "psnr": psnr_from_sse(psum(sses), H * W),
        # The bands' counts are disjoint: each counts its owned rows only.
        "volume_edge_hits": psum(edge_hits),
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


def make_spatial_pipeline(mesh: Mesh, cfg: GMEConfig, H: int, W: int):
    """The fully sharded step: pairs over "data", frame rows over "space".
    Returns step(prev, curr) for (B, H, W) uint8 batches, B a multiple of
    the data size, giving the dict of `gme_pipeline_batch` (without the
    bands) on the first slot's device."""
    space = mesh.shape[SPACE_AXIS]
    validate_spatial_shapes(H, space, cfg, W)
    lh = H // space
    out_dev = mesh.devices[0][0]

    def step(prev: torch.Tensor, curr: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = prev.shape[0]
        if B % len(mesh.devices):
            raise ValueError(f"batch {B} must divide by mesh data={len(mesh.devices)}")
        n = B // len(mesh.devices)
        outs = []
        for d, slots in enumerate(mesh.devices):
            p, c = prev[d * n:(d + 1) * n], curr[d * n:(d + 1) * n]
            o = spatial_gme_step([p[:, s * lh:(s + 1) * lh].to(dev) for s, dev in enumerate(slots)],
                                 [c[:, s * lh:(s + 1) * lh].to(dev) for s, dev in enumerate(slots)],
                                 cfg, H, W)
            outs.append({k: all_gather(v, dim=1).to(out_dev) if isinstance(v, list)
                         else v.to(out_dev) for k, v in o.items()})
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return step
