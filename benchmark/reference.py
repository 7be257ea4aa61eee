"""Plain reference of the results step, in PyTorch, on any device.

It computes, for each frame pair, what `process_video` writes: the PSNR,
the walks that entered the volume's boundary ring (`volume_edge_hits`),
the model motion field, the compensated frame and the diff images.  It is
written from the semantics the configuration states (the reference
results.py and motion.py of global_motion_estimation, with the bounded
search volume of the port), imports nothing of `gme_tpu_torch` or of the
JAX package, and takes nothing the program made: only the frames.

The steps, each as plainly as it goes:

- pyramid: cv2.pyrDown in integers (REFLECT_101 border, taps 1 4 6 4 1,
  `(acc + 128) >> 8`), coarsest level first;
- search: the diamond search of each block by gathering the candidate
  blocks from the frame (exact integer SSD): large-diamond steps from the
  block's origin, every candidate clamped to [0, dim - bs - 1], the first
  minimum of the nine taken, until no block moves (at most `max_iters`
  steps); a candidate more than `radius` from the origin on either axis
  costs +inf (the bounded volume); then one small-diamond pass.  A walk
  whose visited offsets reach the ring max |offset| >= radius - 1 counts
  as an edge hit;
- translation init: the mean of the dense field, as its float32 sum times
  the float32 reciprocal of the cell count; projection: a0, b0 doubled;
- robust fit at each finer level: the affine field of the last parameters
  rounded half to even, the L1 error of each cell against it, the cells
  above the value `int(fraction * n)` places from the end of the ascending
  sort dropped, and the mean-centred normal equations on coordinates
  (row * stride, col * stride) solved from exact integer moments, in
  float32 with fused multiply-adds where the reference's jitted fit has
  them (the parameters' last bits decide where an affine field rounds,
  and fields of small integer sums land on ties of .5);
- the model field on cell indices, rounded half to even; the block warp
  (a pixel whose source leaves the frame keeps its value); PSNR from the
  exact integer SSE.

`fdt` is the float type of the parameters and the fit: float32 with the
fused multiply-adds the configuration states, or bfloat16 for the control
of `check.py` (the precision below the float32 the configuration states,
in plain arithmetic, and the PSNR in it too; the reference takes its PSNR
in float64).  Costs and moments are exact integers in both.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

LDSP = ((0, 0), (2, 0), (1, 1), (0, 2), (-1, 1), (-2, 0), (-1, -1), (0, -2), (1, -1))
SDSP = ((0, 0), (0, 1), (1, 0), (0, -1), (-1, 0))
_INF = 2**62
_TAPS = (1, 4, 6, 4, 1)
# Gathered candidate pixels held at once, to bound the memory of a search.
_GATHER_BUDGET = 2**27


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= n, 2 * n - 2 - idx, idx)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) integer frames -> (B, (H+1)//2, (W+1)//2) int64."""
    _, H, W = x.shape
    x = x.to(torch.int64)
    for dim, n in ((1, H), (2, W)):
        out_n = (n + 1) // 2
        base = torch.arange(out_n, device=x.device) * 2
        acc = 0
        for k, w in enumerate(_TAPS):
            acc = acc + w * x.index_select(dim, _reflect101(base + k - 2, n))
        x = acc
    return (x + 128) >> 8


def pyramid(frames: torch.Tensor, levels: int):
    """[coarsest, ..., frames] as int64."""
    out = [frames.to(torch.int64)]
    for _ in range(1, levels):
        out.insert(0, pyr_down(out[0]))
    return out


def diamond_search(prev: torch.Tensor, curr: torch.Tensor, bs: int, radius: int,
                   max_iters: int):
    """((B, nbh, nbw, 2) int64 field [col shift, row shift], (B,) edge
    hits) of the diamond search of every bs x bs block of `prev` in
    `curr` (module docstring)."""
    B, H, W = prev.shape
    nbh, nbw = H // bs, W // bs
    dev = prev.device
    ar = torch.arange(bs, device=dev)
    origin = torch.stack(torch.broadcast_tensors((torch.arange(nbh, device=dev) * bs)[:, None],
                                                 (torch.arange(nbw, device=dev) * bs)[None, :]),
                         dim=-1)  # (nbh, nbw, 2) (row, col)
    anchors = prev[:, :nbh * bs, :nbw * bs].reshape(B, nbh, bs, nbw, bs).permute(0, 1, 3, 2, 4)
    hi = torch.tensor([H - bs - 1, W - bs - 1], device=dev)
    flat = curr.reshape(B, H * W)
    ldsp, sdsp = (torch.tensor(p, device=dev) for p in (LDSP, SDSP))

    def cost(cands):  # (B, nbh, nbw, K, 2) -> (B, nbh, nbw, K)
        inside = ((cands - origin[:, :, None, :]).abs() <= radius).all(-1)
        rows = cands[..., 0, None] + ar
        cols = cands[..., 1, None] + ar
        idx = rows[..., :, None] * W + cols[..., None, :]
        blocks = flat.gather(1, idx.reshape(B, -1)).reshape(idx.shape)
        d = blocks - anchors[:, :, :, None]
        ssd = (d * d).sum(dim=(-2, -1))
        return torch.where(inside, ssd, torch.full_like(ssd, _INF))

    def step(pos, pattern):
        cands = torch.minimum((pos[..., None, :] + pattern).clamp_min(0), hi)
        k = torch.argmin(cost(cands), dim=-1)
        return torch.gather(cands, -2, k[..., None, None].expand(k.shape + (1, 2)))[..., 0, :]

    pos = origin.expand(B, nbh, nbw, 2).clone()
    touched = torch.zeros(B, nbh, nbw, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        touched |= (pos - origin).abs().amax(dim=-1) >= radius - 1
        nxt = step(pos, ldsp)
        moved = bool((nxt != pos).any())
        pos = nxt
        if not moved:
            break
    best = step(pos, sdsp)
    field = torch.stack([best[..., 1] - origin[..., 1], best[..., 0] - origin[..., 0]], dim=-1)
    return field, touched.reshape(B, -1).sum(dim=1)


def search_chunked(prev, curr, bs: int, radius: int, max_iters: int):
    """`diamond_search` over chunks of pairs, so that the gathered
    candidates stay within `_GATHER_BUDGET` pixels."""
    B, H, W = prev.shape
    per_pair = max(1, (H // bs) * (W // bs) * len(LDSP) * bs * bs)
    n = max(1, _GATHER_BUDGET // per_pair)
    parts = [diamond_search(prev[i:i + n], curr[i:i + n], bs, radius, max_iters)
             for i in range(0, B, n)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add rounds it.
    The product of two float32 values is exact in float64; the float64 sum
    is rounded to odd (an inexact sum whose last bit is even moves one
    float64 step towards the exact value, found by two-sum), and rounding
    to odd with 29 bits to spare makes the rounding to float32 that follows
    equal a single one."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    return torch.where(nudge, torch.nextafter(s, torch.where(err > 0, s + 1, s - 1)), s).float()


def affine_field(shape, params: torch.Tensor, fdt) -> torch.Tensor:
    """(B, nbh, nbw, 2) int64 field of (B, 6) float32 parameters at cell
    indices (row, col): a0 + a1 row + a2 col and b0 + b1 row + b2 col as
    fma(a2, col, fma(a1, row, a0)) in float32 (plain `fdt` arithmetic
    where that is not float32), rounded half to even; NaN gives 0."""
    nbh, nbw = shape
    dev = params.device
    x = torch.arange(nbh, device=dev, dtype=torch.float32)[:, None].expand(nbh, nbw)
    y = torch.arange(nbw, device=dev, dtype=torch.float32)[None, :].expand(nbh, nbw)
    p = params.to(torch.float32)[:, :, None, None]
    if fdt == torch.float32:
        d0 = fma32(p[:, 2], y, fma32(p[:, 1], x, p[:, 0]))
        d1 = fma32(p[:, 5], y, fma32(p[:, 4], x, p[:, 3]))
    else:
        p, x, y = p.to(fdt), x.to(fdt), y.to(fdt)
        d0 = p[:, 0] + p[:, 1] * x + p[:, 2] * y
        d1 = p[:, 3] + p[:, 4] * x + p[:, 5] * y
    d = torch.round(torch.stack([d0, d1], dim=-1).double())
    return d.nan_to_num(0.0).clamp(-32768, 32767).to(torch.int64)


def first_parameters(field: torch.Tensor, fdt) -> torch.Tensor:
    """(B, 6) float32 translation: the field's mean, as its float32 sum
    times the float32 reciprocal of the cell count."""
    B, nbh, nbw, _ = field.shape
    inv = (torch.tensor(1.0, dtype=torch.float32) / (nbh * nbw)).to(fdt).to(field.device)
    mean = field.to(torch.float32).sum(dim=(1, 2)).to(fdt) * inv
    z = torch.zeros(B, dtype=fdt, device=field.device)
    return torch.stack([mean[:, 0], z, z, mean[:, 1], z, z], dim=-1).to(torch.float32)


def inliers(field: torch.Tensor, predicted: torch.Tensor, fraction: float) -> torch.Tensor:
    """(B, nbh, nbw) cells kept by the outlier rejection."""
    err = (field - predicted).abs().sum(dim=-1)
    B = err.shape[0]
    ranked = torch.sort(err.reshape(B, -1), dim=-1).values
    n = ranked.shape[1]
    threshold = ranked[:, (n - int(fraction * n)) % n]
    return err <= threshold[:, None, None]


def fit(field: torch.Tensor, keep: torch.Tensor, stride: int, fdt) -> torch.Tensor:
    """(B, 6) float32 least-squares affine parameters of the kept cells,
    from exact integer moments over (row * stride, col * stride): in
    float32 with the fused multiply-adds the configuration states (the
    reference's jitted fit as XLA:CPU compiles it), or plainly in `fdt`."""
    _, nbh, nbw, _ = field.shape
    dev = field.device
    m = keep.to(torch.int64)
    x = (torch.arange(nbh, device=dev) * stride)[:, None].expand(nbh, nbw)
    y = (torch.arange(nbw, device=dev) * stride)[None, :].expand(nbh, nbw)

    def s(t):  # exact integer sum over kept cells, then the float type
        return (t * m).sum(dim=(1, 2)).to(fdt)

    n, Sx, Sy = s(torch.ones_like(x)), s(x), s(y)
    xbar, ybar = Sx / n, Sy / n
    if fdt == torch.float32:
        def f(a, b, c):
            return fma32(a, b, c)
    else:
        def f(a, b, c):
            return a * b + c
    Gxx, Gxy, Gyy = f(-Sx, xbar, s(x * x)), f(-Sx, ybar, s(x * y)), f(-Sy, ybar, s(y * y))
    det = f(Gxx, Gyy, -(Gxy * Gxy))
    out = []
    for k in range(2):
        d = field[..., k]
        Sd = s(d)
        bx, by = f(-xbar, Sd, s(x * d)), f(-ybar, Sd, s(y * d))
        a1 = f(bx, Gyy, -(by * Gxy)) / det
        a2 = f(by, Gxx, -(bx * Gxy)) / det
        out += [f(-a2, ybar, f(-a1, xbar, Sd / n)), a1, a2]
    return torch.stack(out, dim=-1).to(torch.float32)


def compensate(frame: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Block warp of (B, H, W) frames by (B, nbh, nbw, 2) [col, row]
    shifts: the pixel at (r, c) of a covered block takes the frame's pixel
    at (r - row shift, c - col shift), or keeps its own where that lies
    outside the frame."""
    B, H, W = frame.shape
    nbh, nbw = field.shape[1:3]
    bs = H // nbh
    ch, cw = nbh * bs, nbw * bs
    dev = frame.device
    r = torch.arange(ch, device=dev)[:, None].expand(ch, cw)
    c = torch.arange(cw, device=dev)[None, :].expand(ch, cw)
    per_px = field.repeat_interleave(bs, dim=1).repeat_interleave(bs, dim=2)
    sr, sc = r - per_px[..., 1], c - per_px[..., 0]
    ok = (sr >= 0) & (sr < H) & (sc >= 0) & (sc < W)
    src = torch.where(ok, sr * W + sc, r * W + c)
    out = frame.clone()
    out[:, :ch, :cw] = frame.reshape(B, -1).gather(1, src.reshape(B, -1)).reshape(B, ch, cw)
    return out


def psnr(a: torch.Tensor, b: torch.Tensor, fdt) -> torch.Tensor:
    """(B,) PSNR in dB from the exact integer SSE, in float64 (in `fdt`
    where that is below float32); -1 for equal frames."""
    d = a.to(torch.int64) - b.to(torch.int64)
    sse = (d * d).reshape(d.shape[0], -1).sum(dim=1)
    mse = sse.to(torch.float64 if fdt == torch.float32 else fdt) / (a.shape[-2] * a.shape[-1])
    val = 20.0 * torch.log10(255.0 / torch.sqrt(mse))
    return torch.where(sse == 0, torch.full_like(val, -1.0), val).double()


def step(prev: torch.Tensor, curr: torch.Tensor, gme: dict, fdt=torch.float32) -> Dict:
    """The results step of (B, H, W) uint8 pairs under the `gme` settings
    of a configuration: psnr, volume_edge_hits, parameters,
    model_motion_field and compensated."""
    levels, bs = gme["pyramid_levels"], gme["block_size"]
    pp, cp = pyramid(prev, levels), pyramid(curr, levels)
    field, hits = search_chunked(pp[0], cp[0], gme["dense_block_size"],
                                 gme["dense_volume_radius"], gme["max_search_iters"])
    params = first_parameters(field, fdt)
    for lvl in range(1, levels):
        params = params.clone()
        params[:, 0::3] *= 2.0
        field, h = search_chunked(pp[lvl], cp[lvl], bs, gme["volume_radius"],
                                  gme["max_search_iters"])
        hits = hits + h
        keep = inliers(field, affine_field(field.shape[1:3], params, fdt),
                       gme["outlier_fraction"])
        params = fit(field, keep, gme["coord_stride"], fdt)
    _, H, W = prev.shape
    model = affine_field((H // bs, W // bs), params, fdt)
    comp = compensate(prev, model)
    return {
        "psnr": psnr(curr, comp, fdt),
        "volume_edge_hits": hits,
        "parameters": params,
        "model_motion_field": model,
        "compensated": comp,
    }


def clip(frames: torch.Tensor, gme: dict, frame_distance: int, batch: int,
         keep_images: Iterable[int] = (), fdt=torch.float32) -> Dict:
    """The reference over a whole clip of (N, H, W) uint8 frames on their
    device: {"psnr": {pair index: dB}, "volume_edge_hits": total,
    "images": {pair index: (model field, compensated) as numpy}} for the
    pair indices in `keep_images`.  A pair index is the index of its
    current frame, as in psnr_records.json."""
    keep = set(keep_images)
    idx = list(range(frame_distance, frames.shape[0]))
    out = {"psnr": {}, "volume_edge_hits": 0, "images": {}}
    for i in range(0, len(idx), batch):
        part = idx[i:i + batch]
        cur = torch.tensor(part, device=frames.device)
        res = step(frames[cur - frame_distance], frames[cur], gme, fdt)
        out["volume_edge_hits"] += int(res["volume_edge_hits"].sum())
        for k, j in enumerate(part):
            out["psnr"][j] = float(res["psnr"][k])
            if j in keep:
                out["images"][j] = (res["model_motion_field"][k].cpu().numpy(),
                                    res["compensated"][k].cpu().numpy())
    return out

