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
`utils.compiled.transfer`.  As JAX's `lax.psum` and `lax.all_gather` leave
their results on every shard, `psum` and the errors' `all_gather` deliver
to every device of the bands: each device sorts its copy of the errors,
solves its copy of the moments and builds the affine and model fields from
its own parameters (`Replicated`), so nothing is sent back out; only the
program's inputs are broadcast and scattered.  The bands that share a
device run stacked into the pair dimension (`_by_device`): every band has
the same (Tmax*bs, nbw*bs) shape (`_band_tmax`), so the pyramid taps, the
block pads, the volume kernels and the chase, the moments, the error
diffs, the compensation gather and the metrics run once per device, as
the single-device step runs them once; the collectives take per-band views
of the stacked tensors.

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

from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

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
# A replicated value: one copy on each device of the bands, in band order
# (`_devices`), as `lax.psum` and `lax.all_gather` leave theirs on every shard.
Replicated = Dict[torch.device, Any]


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


def psum(parts: Sequence) -> Replicated:
    """The sum of the bands' tensors, or of each tuple of tensors as
    `lax.psum` sums a tree, on every device of the bands, as `lax.psum`
    leaves it on every shard.  Each band's part goes to every device but
    the one whose own part it adds to first, in one transfer (on one device:
    every part but the first band's), and each device adds the parts up in
    band order.  Integer sums are exact in any order, so every copy is
    bit-equal."""
    tree = isinstance(parts[0], tuple)
    rows = [p if tree else (p,) for p in parts]
    devs = _devices([r[0] for r in rows])
    home = {d: next(k for k, r in enumerate(rows) if r[0].device == d) for d in devs}
    moved = iter(transfer([(t, d) for d in devs for k, r in enumerate(rows) if k != home[d]
                           for t in r]))
    out = {}
    for d in devs:
        got = [r if k == home[d] else tuple(next(moved) for _ in r) for k, r in enumerate(rows)]
        totals = tuple(torch.stack(col).sum(0, dtype=col[0].dtype) for col in zip(*got))
        out[d] = totals if tree else totals[0]
    return out


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
    the rows; of each replicated value the copy on `device`, or else the
    first device's copy moved there."""
    leaves = []
    for v in out.values():
        if isinstance(v, list):
            leaves += v
        elif device not in v:
            leaves.append(next(iter(v.values())))
    moved = iter(transfer([(t, device) for t in leaves]))
    got = {}
    for k, v in out.items():
        if isinstance(v, list):
            got[k] = torch.cat([next(moved) for _ in v], dim=1)
        else:
            got[k] = v[device] if device in v else next(moved)
    return got


# The functions above are the only ones that move tensors between devices
# (tests/test_torch_compiled.py reads this module to hold it so): there a
# split capture of the band program ends its per-device graphs.
COLLECTIVES = ("_exchange", "extend_rows", "psum", "all_gather", "broadcast", "scatter_rows",
               "gather")


def _devices(bands: Bands) -> List[torch.device]:
    """The bands' devices, each once, in band order."""
    return list(dict.fromkeys(b.device for b in bands))


def _by_device(bands: Bands) -> List[List[int]]:
    """The band indices grouped by device, in band order."""
    groups: Dict[torch.device, List[int]] = {}
    for k, b in enumerate(bands):
        groups.setdefault(b.device, []).append(k)
    return list(groups.values())


def _stack(bands: Bands, ks: List[int]) -> torch.Tensor:
    """The bands `ks` (all on one device) stacked into the pair dimension."""
    return torch.cat([bands[k] for k in ks]) if len(ks) > 1 else bands[ks[0]]


def _unstack(t: torch.Tensor, ks: List[int], out: list) -> None:
    """Split a tensor stacked over the bands `ks` (leading dim
    len(ks) * B) back into `out[k]`, views of `t`."""
    for i, part in enumerate(t.reshape((len(ks), -1) + tuple(t.shape[1:]))):
        out[ks[i]] = part


def _band_ints(values: List[int], device) -> torch.Tensor:
    """(len(values),) int32 per-band integers, filled on `device`: a tensor
    built from a host list would be a copy from the host, which a CUDA
    graph capture cannot hold.  One fill, or one arange where the values
    step evenly."""
    if len(set(values)) == 1:
        return torch.full((len(values),), values[0], dtype=torch.int32, device=device)
    steps = {b - a for a, b in zip(values, values[1:])}
    if len(steps) == 1:
        step = steps.pop()
        return torch.arange(values[0], values[0] + step * len(values), step, dtype=torch.int32,
                            device=device)
    return torch.cat([torch.full((1,), v, dtype=torch.int32, device=device) for v in values])


# ---------------------------------------------------------------------------
# Gaussian pyramid on row bands
# ---------------------------------------------------------------------------

def _pyrdown_band(bands: Bands) -> Bands:
    """One cv2.pyrDown level on the row bands: a 2-row halo exchange, and
    REFLECT_101 at the frame's top and bottom only (JAX spatial.py:109-131),
    the taps once per device on its stacked bands.  Band heights must be
    even (`validate_spatial_shapes`)."""
    S = len(bands)
    B, lh, W = bands[0].shape
    ext = extend_rows(bands, 2, 2)  # (B, lh + 4, W) uint8
    out = [None] * S
    for ks in _by_device(bands):
        e = torch.cat([ext[k] for k in ks])  # a fresh tensor: its edge rows are set below
        if ks[0] == 0:  # rows -2, -1 -> 2, 1
            e[:B, :2] = bands[0][:, 1:3].flip(1)
        if ks[-1] == S - 1:  # rows H, H + 1 -> H - 2, H - 3
            e[-B:, lh + 2:] = bands[S - 1][:, lh - 3:lh - 1].flip(1)
        e = F.pad(e.float(), (2, 2), mode="reflect")  # columns: numpy's "reflect"
        acc = _taps_stride2(_taps_stride2(e, 1, lh // 2), 2, (W + 1) // 2)
        _unstack(torch.floor((acc + 128.0) * (1.0 / 256.0)).byte(), ks, out)
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


class _Blocks(NamedTuple):
    """A device's stacked bands of one level (`_band_blocks`)."""
    ks: List[int]  # its bands, in band order
    first: List[int]  # each band's first owned block row (gb0)
    gb0: torch.Tensor  # (len(ks),) int32: `first` on the device
    valid: torch.Tensor  # (len(ks), Tmax) bool: the owned block rows
    prev: torch.Tensor  # (len(ks)*B, Tmax*bs, nbw*bs) uint8
    curr: torch.Tensor  # (len(ks)*B, Tmax*bs + above + below, nbw*bs + above + right) uint8


class _Field(NamedTuple):
    """A device's share of a banded block field (`_banded_field`)."""
    ks: List[int]
    first: List[int]
    gb0: torch.Tensor  # (len(ks),) int32
    valid: torch.Tensor  # (len(ks), Tmax) bool
    field: torch.Tensor  # (len(ks)*B, Tmax, nbw, 2) int32
    hits: torch.Tensor  # (len(ks)*B,) int32 ring visits of the owned rows


def _band_blocks(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                 above: int, below: int, right: int) -> List[_Blocks]:
    """Each device's volume inputs (JAX spatial.py:163-210, 326-347), its
    bands stacked: of each band the previous-frame rows [gb0*bs,
    (gb0+Tmax)*bs), cropped to whole blocks, and the current-frame rows
    [gb0*bs - above, (gb0+Tmax)*bs + below), columns padded by `above` on
    the left and cropped to nbw*bs + above + right (one pad a device),
    uint8 with zeros beyond the frame."""
    S = len(prev_bands)
    lh = prev_bands[0].shape[1]
    nbw = _block_grid(H, W, bs)[1]
    Tmax = _band_tmax(H, S, bs)
    ext_b = max(0, Tmax * bs + bs - 1 - lh)
    prev_ext, curr_ext = _exchange([([p[:, :, : nbw * bs] for p in prev_bands], 0, ext_b),
                                    (curr_bands, above, ext_b + below)])
    rows = [_band_rows(k, lh, H, bs) for k in range(S)]
    start = [rows[k][0] * bs - k * lh for k in range(S)]  # in [0, bs)
    out = []
    for ks in _by_device(prev_bands):
        dev = prev_bands[ks[0]].device
        prev = torch.cat([prev_ext[k][:, start[k]:start[k] + Tmax * bs] for k in ks])
        curr = torch.cat([curr_ext[k][:, start[k]:start[k] + Tmax * bs + above + below]
                          for k in ks])
        # Pad `above` columns on the left; pad or crop the right to nbw*bs + right.
        curr = F.pad(curr, (above, nbw * bs + right - W))
        first = [rows[k][0] for k in ks]
        owned = _band_ints([max(rows[k][1] - rows[k][0], 0) for k in ks], dev)
        valid = torch.arange(Tmax, dtype=torch.int32, device=dev) < owned[:, None]
        out.append(_Blocks(ks, first, _band_ints(first, dev), valid, prev, curr))
    return out


def _stacked_origins(gb0: torch.Tensor, B: int, Tmax: int, nbw: int, bs: int) -> torch.Tensor:
    """(len(gb0) * B, Tmax, nbw, 2) int32 global block origins of stacked
    bands whose first block rows are `gb0`."""
    gi = (gb0[:, None] + torch.arange(Tmax, dtype=torch.int32, device=gb0.device)) * bs
    gj = torch.arange(nbw, dtype=torch.int32, device=gb0.device) * bs
    og = torch.stack(torch.broadcast_tensors(gi[:, :, None], gj[None, None, :]), dim=-1)
    return og[:, None].expand(-1, B, -1, -1, -1).reshape(-1, Tmax, nbw, 2)


def _per_pair(t: torch.Tensor, B: int) -> torch.Tensor:
    """A per-band (n, ...) tensor repeated for each of the B pairs of its
    band: (n*B, ...)."""
    return t[:, None].expand((t.shape[0], B) + tuple(t.shape[1:])).reshape(
        (-1,) + tuple(t.shape[1:]))


def _banded_volume(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int, R: int,
                   pnorm: int):
    """The masked banded cost volumes of the diamond and three-step walks
    (JAX spatial.py:163-217), one `compute_cost_volume_band` per device on
    the stacked bands: [(blocks, volume (len(ks)*B, Tmax, nbw, D*D),
    origins (len(ks)*B, Tmax, nbw, 2))] per device."""
    B = prev_bands[0].shape[0]
    out = []
    for blk in _band_blocks(prev_bands, curr_bands, H, W, bs, R, R, R):
        Tmax, nbw = blk.prev.shape[1] // bs, blk.prev.shape[2] // bs
        vol = compute_cost_volume_band(blk.prev, blk.curr, _per_pair(blk.gb0, B), (H, W), bs,
                                       R, pnorm)
        out.append((blk, vol, _stacked_origins(blk.gb0, B, Tmax, nbw, bs)))
    return out


def banded_diamond_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                         radius: int, pnorm: int, max_iters: int) -> List[_Field]:
    """Diamond-search field of each band's block rows, per device (the
    edge hits count the owned rows only).  Walk semantics of the
    single-device volume-engine `diamond_search`."""
    B = prev_bands[0].shape[0]
    out = []
    for blk, vol, origins in _banded_volume(prev_bands, curr_bands, H, W, bs, radius, pnorm):
        count = _per_pair(blk.valid, B)[:, :, None].expand(origins.shape[:3])
        best, edge = diamond_walk_volume(vol, origins, H, W, bs, radius, max_iters,
                                         count_mask=count)
        out.append(_Field(blk.ks, blk.first, blk.gb0, blk.valid, _field(best, origins), edge))
    return out


def banded_threestep_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                           sw: int, pnorm: int) -> List[_Field]:
    """Three-step field of each band's block rows: the banded volume at
    three-step's exact radius and the single-device rounds
    (`ops.bbme.threestep_walk`) on global coordinates; the contract of
    `banded_diamond_field`, edge hits 0."""
    R = threestep_search_radius(bs, sw)
    out = []
    for blk, vol, origins in _banded_volume(prev_bands, curr_bands, H, W, bs, R, pnorm):
        d = threestep_walk(volume_evaluator(vol, origins, R), origins, H, W, bs, sw)
        field = torch.stack([d[..., 1], d[..., 0]], dim=-1).int()
        out.append(_Field(blk.ks, blk.first, blk.gb0, blk.valid, field, _no_hits(field)))
    return out


def banded_exhaustive_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int,
                            sw: int, pnorm: int) -> List[_Field]:
    """Exhaustive field of each band's block rows: the band's volume over
    the window range(-sw, sw + bs) and a masked first-minimum argmin, column
    offset outer (JAX spatial.py:293-380, reference bbme.py:105-179); the
    contract of `banded_diamond_field`, edge hits 0."""
    D = 2 * sw + bs
    B = prev_bands[0].shape[0]
    out = []
    for blk in _band_blocks(prev_bands, curr_bands, H, W, bs, sw, sw + bs - 1, sw + bs - 1):
        n, dev = len(blk.ks), blk.prev.device
        Tmax, nbw = blk.prev.shape[1] // bs, blk.prev.shape[2] // bs
        vol = _dfd_cost_volume(blk.prev, blk.curr, bs, D, pnorm)
        offsets = torch.arange(-sw, sw + bs, dtype=torch.int32, device=dev)
        ar = torch.arange(Tmax, dtype=torch.int32, device=dev)
        row = ((blk.gb0[:, None] + ar) * bs)[..., None]
        valid_r = (row + offsets >= 0) & (row + offsets <= H - bs)  # (n, Tmax, D_wr)
        valid_c = _offset_mask(nbw, bs, W, offsets)  # (nbw, D_wc)
        mask = valid_r[:, None, :, None, None, :] & valid_c[None, None, None, :, :, None]
        cost = vol.reshape(n, B, Tmax, nbw, D, D).transpose(-1, -2)  # (.., D_wc, D_wr)
        cost = cost.masked_fill(~mask, _INF).reshape(n * B, Tmax, nbw, D * D)
        kk = torch.argmin(cost, dim=-1)  # first minimum == the reference's scan order
        field = torch.stack([offsets[kk // D], offsets[kk % D]], dim=-1)
        out.append(_Field(blk.ks, blk.first, blk.gb0, blk.valid, field, _no_hits(field)))
    return out


def _no_hits(field: torch.Tensor) -> torch.Tensor:
    return torch.zeros(field.shape[0], dtype=torch.int32, device=field.device)


def _banded_field(prev_bands: Bands, curr_bands: Bands, H: int, W: int, bs: int, radius: int,
                  cfg: GMEConfig) -> List[_Field]:
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

def _per_band(groups: Sequence[_Field], stacked: Sequence[torch.Tensor]) -> list:
    """Per-band views of tensors stacked per device (leading dim
    len(ks) * B), in band order: what the collectives take."""
    out = [None] * sum(len(g.ks) for g in groups)
    for g, t in zip(groups, stacked):
        _unstack(t, g.ks, out)
    return out


def _first_params_psum(groups: Sequence[_Field]) -> Replicated:
    """Translation-only init: a0, b0 = the mean of the dense field over the
    owned cells (reference motion.py:160-188), the sums psum'd and divided
    on every device as JAX spatial.py:396-413 divides them.  (B, 6) float32
    on each device."""
    parts = []
    for g in groups:
        n, nbw = len(g.ks), g.field.shape[2]
        m = g.valid.long()[:, None, :, None]  # (n, 1, Tmax, 1)
        f = g.field.reshape((n, -1) + tuple(g.field.shape[1:])).long() * m[..., None]
        count = (m.sum(dim=(1, 2, 3)) * nbw)[:, None].expand(f.shape[:2])
        parts.append(torch.stack([f[..., 0].sum(dim=(2, 3)), f[..., 1].sum(dim=(2, 3)), count],
                                 dim=-1).reshape(-1, 3))
    out = {}
    for d, sums in psum(_per_band(groups, parts)).items():
        sums = sums.float()
        a0 = sums[:, 0] / sums[:, 2]
        b0 = sums[:, 1] / sums[:, 2]
        z = torch.zeros_like(a0)
        out[d] = torch.stack([a0, z, z, b0, z, z], dim=1)
    return out


def _fit_psum(groups: Sequence[_Field], inliers: Sequence[torch.Tensor],
              coord_stride: int) -> Replicated:
    """Distributed least-squares affine fit: one `int_moments` a device over
    its stacked bands, with global block rows, one psum of the bands'
    moments, and the single-device solve on every device, so each copy of
    the parameters equals `fit_normal_equations`' (JAX spatial.py:416-437:
    every shard solves the identical system)."""
    B = groups[0].field.shape[0] // len(groups[0].ks)
    moments = [int_moments(g.field, m, coord_stride, row0=_per_pair(g.gb0, B))
               for g, m in zip(groups, inliers)]
    return {d: params_from_moments(m) for d, m in psum(_per_band(groups, moments)).items()}


def _outlier_inliers(groups: Sequence[_Field], affine: Sequence[torch.Tensor],
                     outlier_fraction: float, n_cells: int) -> List[torch.Tensor]:
    """Distributed outlier rejection (reference motion.py:236-244): the
    per-cell L1 errors of every band, +inf in padding rows, all-gathered to
    every device, where each sorts its copy per pair and takes the
    threshold at `(n - int(f*n)) % n`, as in JAX spatial.py:440-463.
    Returns each device's stacked INLIER mask of its owned cells."""
    diffs, errs = [], []
    for g, a in zip(groups, affine):
        n = len(g.ks)
        d = (g.field.int() - a.int()).abs().sum(dim=-1).float()
        d = d.reshape((n, -1) + tuple(d.shape[1:]))  # (n, B, Tmax, nbw)
        diffs.append(d)
        errs.append(torch.where(g.valid[:, None, :, None], d, float("inf")).flatten(0, 1))
    devs = [g.field.device for g in groups]
    gathered = all_gather(_per_band(groups, errs), 1, devs)  # (B, S*Tmax, nbw) on each
    out = []
    for g, d, full in zip(groups, diffs, gathered):
        flat = torch.sort(full.reshape(full.shape[0], -1), dim=1).values
        threshold = flat[:, (n_cells - int(outlier_fraction * n_cells)) % n_cells]
        keep = ~(d > threshold[None, :, None, None]) & g.valid[:, None, :, None]
        out.append(keep.flatten(0, 1))
    return out


def _affine_rows(parameters: Replicated, nbh: int, nbw: int,
                 groups: Sequence[_Field]) -> List[torch.Tensor]:
    """Of the dense affine field that each device builds from its own
    parameters (B, nbh, nbw, 2), rows [gb0, gb0 + Tmax) of each of its
    bands, zero past the last row, stacked (JAX spatial.py:466-472)."""
    out = []
    for g in groups:
        full = get_motion_field_affine((nbh, nbw), parameters[g.field.device])
        Tmax = g.field.shape[1]
        padded = F.pad(full, (0, 0, 0, 0, 0, Tmax))
        out.append(torch.cat([padded[:, r:r + Tmax] for r in g.first]) if len(g.first) > 1
                   else padded[:, g.first[0]:g.first[0] + Tmax])
    return out


# ---------------------------------------------------------------------------
# The spatially-sharded per-pair step
# ---------------------------------------------------------------------------

def spatial_gme_step(prev_bands: Bands, curr_bands: Bands, cfg: GMEConfig, H: int,
                     W: int) -> Dict[str, object]:
    """One full pipeline step on the row bands of (B, H, W) uint8 frames
    (JAX spatial.py:470-585): pyramid, dense init, per-level robust re-fit,
    dense affine field, compensation, differences, PSNR.  Each device runs
    its bands stacked into the pair dimension, one op a device where the
    single-device step runs one.  The band-sharded outputs ("compensated",
    "diff_curr_prev", "diff_curr_comp") are lists of (B, lh, W) bands; the
    others are `Replicated`: every device of the bands holds its own copy,
    as every shard does in JAX ("psnr" and "volume_edge_hits" from the
    psum'd sums, the fields from each device's own parameters), and
    `gather` takes the output device's copy."""
    levels = cfg.pyramid_levels
    Hs, Ws = [H], [W]
    for _ in range(1, levels):
        Hs.insert(0, Hs[0] // 2)
        Ws.insert(0, (Ws[0] + 1) // 2)

    prev_pyr = _pyramids_band(prev_bands, levels)
    curr_pyr = _pyramids_band(curr_bands, levels)

    dense = _banded_field(prev_pyr[0], curr_pyr[0], Hs[0], Ws[0], cfg.dense_block_size,
                          cfg.dense_volume_radius, cfg)
    edge_hits = [g.hits for g in dense]
    parameters = _first_params_psum(dense)

    for i in range(1, levels):
        parameters = {d: parameter_projection(p) for d, p in parameters.items()}
        nbh, nbw = _block_grid(Hs[i], Ws[i], cfg.block_size)
        groups = _banded_field(prev_pyr[i], curr_pyr[i], Hs[i], Ws[i], cfg.block_size,
                               cfg.volume_radius, cfg)
        edge_hits = [a + g.hits for a, g in zip(edge_hits, groups)]
        aff = _affine_rows(parameters, nbh, nbw, groups)
        inliers = _outlier_inliers(groups, aff, cfg.outlier_fraction, nbh * nbw)
        parameters = _fit_psum(groups, inliers, cfg.coord_stride)

    nbh_f, nbw_f = _block_grid(H, W, cfg.block_size)
    model_motion_field = {d: get_motion_field_affine((nbh_f, nbw_f), p)
                          for d, p in parameters.items()}

    # Compensation of each device's stacked bands against the all-gathered
    # previous frame (reference motion.py:289-321: uncovered and
    # out-of-frame pixels keep the original value).
    S = len(prev_bands)
    B, lh = prev_bands[0].shape[:2]
    warp_bs = H // nbh_f  # reference motion.py:303 derives bs from the ratio
    devs = _devices(prev_bands)
    prev_full = dict(zip(devs, all_gather(prev_bands, 1, devs)))
    compensated, diff_cp, diff_cc, sses = [None] * S, [None] * S, [None] * S, [None] * S
    for ks in _by_device(prev_bands):
        dev = prev_bands[ks[0]].device
        n = len(ks)
        p, c = _stack(prev_bands, ks), _stack(curr_bands, ks)
        rr = (_band_ints([k * lh for k in ks], dev)[:, None]
              + torch.arange(lh, dtype=torch.int32, device=dev))  # (n, lh) global rows
        cc = torch.arange(W, dtype=torch.int32, device=dev)
        d = model_motion_field[dev].int()
        d_px = d[:, (rr // warp_bs).clamp(0, nbh_f - 1).long()[:, :, None],
                 (cc // warp_bs).clamp(0, nbw_f - 1).long()]  # (B, n, lh, W, 2)
        d_px = d_px.transpose(0, 1)  # (n, B, lh, W, 2)
        rr, cc = rr[:, None, :, None], cc[None, None, None, :]
        covered = (rr < nbh_f * warp_bs) & (cc < nbw_f * warp_bs)
        src_r = rr - d_px[..., 1]
        src_c = cc - d_px[..., 0]
        ok = covered & (src_r >= 0) & (src_c >= 0) & (src_r < H) & (src_c < W)
        idx = (src_r.clamp(0, H - 1) * W + src_c.clamp(0, W - 1)).reshape(n, B, -1)
        src = prev_full[dev].reshape(1, B, H * W).expand(n, B, H * W)
        warped = src.gather(2, idx.long()).reshape(n * B, lh, W)
        comp = torch.where(ok.reshape(n * B, lh, W), warped, p)
        _unstack(comp, ks, compensated)
        _unstack(sse(c, comp), ks, sses)
        _unstack(frame_difference(c, p), ks, diff_cp)
        _unstack(frame_difference(c, comp), ks, diff_cc)

    # The bands' edge-hit counts are disjoint: each counts its owned rows only.
    hits = _per_band(dense, edge_hits)
    totals = psum(list(zip(sses, hits)))
    return {
        "parameters": parameters,
        "model_motion_field": model_motion_field,
        "compensated": compensated,
        "diff_curr_prev": diff_cp,
        "diff_curr_comp": diff_cc,
        "psnr": {d: psnr_from_sse(t[0], H * W) for d, t in totals.items()},
        "volume_edge_hits": {d: t[1] for d, t in totals.items()},
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
