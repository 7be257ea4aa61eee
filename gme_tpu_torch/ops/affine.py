"""Affine global-motion model: dense field, least-squares fit, outlier mask.

Counterpart of `gme_tpu/ops/affine.py`, batched over a leading pair
dimension B.  Parameters are (B, 6) float32 [a0, a1, a2, b0, b1, b2] with
displacement d = [a0 + a1*x + a2*y, b0 + b1*x + b2*y] at cell (x=row, y=col)
(reference motion.py:91-105).

Exactness: every float expression is a sequence of separate eager ops, each
correctly rounded, so the port's CPU and CUDA runs agree bit for bit (a
division by a tensor is an IEEE division on both).  They also follow what
the JAX package compiles to under `jit` on an x86 CPU with FMA, bit for
bit.  XLA turns a division by a constant count into a multiply by its
float32 reciprocal; `compute_first_parameters` does the same.  XLA:CPU also
contracts `a*b + c` into one fused multiply-add (the x86 backend does it:
the optimised LLVM IR has none, the object code does).  `_fma` rounds such
a term once, as the instruction does.  `params_from_moments` and
`affine_model` use it exactly where XLA's object code has an FMA, as read
with `objdump -d` from the objects that `XLA_FLAGS=--xla_dump_to=...`
leaves for the jitted step.  Off an FMA host XLA rounds every product,
and the parameters then differ from JAX's by an ulp or so.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gme_tpu_torch.utils import guards


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, like an FMA instruction.

    The product of two float32 values is exact in float64; the sum is taken
    in float64 with its exact error (two-sum), rounded to odd (an inexact
    sum with an even last bit moves one float64 ulp towards the exact
    value) and then rounded to float32 once.  Rounding to odd with 29 spare
    bits makes the two roundings equal one.  Separate eager ops only, so
    the CPU and the card agree; callers stack independent terms into one
    call, since each op is a launch on the card."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    # err * inf is +-inf where the sum is inexact (nan where it is exact,
    # and not taken there).  An infinite or NaN sum stays as it is: its
    # err is NaN, and an FMA instruction gives that sum too.
    inexact = (err != 0) & even & torch.isfinite(s)
    return torch.where(inexact, torch.nextafter(s, err * math.inf), s).float()


def _cell_coords(nbh: int, nbw: int, dtype, device):
    xs = torch.arange(nbh, dtype=dtype, device=device)[:, None].expand(nbh, nbw)
    ys = torch.arange(nbw, dtype=dtype, device=device)[None, :].expand(nbh, nbw)
    return xs, ys


def affine_model(x, y, parameters: torch.Tensor) -> torch.Tensor:
    """(B, *x.shape, 2) displacement of positions (x, y) under (B, 6)
    parameters (reference motion.py:91-105)."""
    p = parameters.to(torch.float32).reshape(parameters.shape[:1] + (2, 3) + (1,) * x.dim())
    # Both products fused, as XLA:CPU fuses them: fma(p2, y, fma(p1, x, p0)),
    # d0 and d1 in one call each.
    d = _fma(p[:, :, 2], y, _fma(p[:, :, 1], x, p[:, :, 0]))  # (B, 2, *x.shape)
    return torch.movedim(d, 1, -1)


def get_motion_field_affine(
    shape: Tuple[int, int], parameters: torch.Tensor
) -> torch.Tensor:
    """(B, shape[0], shape[1], 2) int16 field from (B, 6) parameters,
    rounded half to even like Python's round() (reference motion.py:139-157);
    `torch.round` rounds half to even as `jnp.round` does.

    The conversion to int16 is XLA's: NaN gives 0 and values beyond the
    int16 range saturate (inf included), so the NaN parameters of a
    degenerate fit give the JAX package's field.  A plain `.to(torch.int16)`
    of NaN or of an out-of-range value is not defined."""
    nbh, nbw = int(shape[0]), int(shape[1])
    xs, ys = _cell_coords(nbh, nbw, torch.float32, parameters.device)
    d = torch.round(affine_model(xs, ys, parameters))
    lo, hi = float(torch.iinfo(torch.int16).min), float(torch.iinfo(torch.int16).max)
    return d.nan_to_num_(0.0).clamp_(lo, hi).to(torch.int16)


def compute_first_parameters(dense_motion_field: torch.Tensor) -> torch.Tensor:
    """Translation-only init: a0/b0 = mean shift (reference motion.py:176-188).
    (B, nbh, nbw, 2) int field -> (B, 6) float32.

    The mean is the exact integer sum times the float32 reciprocal of the
    cell count, which is what `jnp.mean` compiles to under XLA."""
    f = dense_motion_field.to(torch.float32)
    inv_n = (torch.tensor(1.0) / torch.tensor(float(f.shape[1] * f.shape[2]))).to(f.device)
    a0 = f[..., 0].sum(dim=(1, 2)) * inv_n
    b0 = f[..., 1].sum(dim=(1, 2)) * inv_n
    z = torch.zeros_like(a0)
    return torch.stack([a0, z, z, b0, z, z], dim=-1)


def parameter_projection(parameters: torch.Tensor) -> torch.Tensor:
    """Project params one pyramid level finer: a0 *= 2, b0 *= 2
    (reference motion.py:191-207)."""
    scale = torch.tensor([2.0, 1.0, 1.0, 2.0, 1.0, 1.0], dtype=torch.float32,
                         device=parameters.device)
    return parameters * scale


def moments_fit_ok(
    nbh: int, nbw: int, frame_shape: Tuple[int, int], coord_stride: int
) -> bool:
    """Static overflow check for the exact integer-moment fit: every moment
    sum must fit int32 (as in the JAX package, so both take the same path;
    1080p frames fall back to the f32 fit)."""
    n = nbh * nbw
    xmax = max((nbh - 1) * coord_stride, 1)
    ymax = max((nbw - 1) * coord_stride, 1)
    dmax = max(frame_shape)
    worst = max(
        n * xmax * ymax,
        n * xmax * xmax,
        n * ymax * ymax,
        n * max(xmax, ymax) * dmax,
        n * dmax,
    )
    return worst < 2**31 - 1


def int_moments(
    motion_field: torch.Tensor, inlier_mask: torch.Tensor, coord_stride: int = 4,
    row0=0,
) -> torch.Tensor:
    """(B, 12) exact integer moment sums of the normal equations over inlier
    cells: [n, Σx, Σy, Σxx, Σxy, Σyy, Σd0, Σx·d0, Σy·d0, Σd1, Σx·d1, Σy·d1]
    with x = (row0 + i)·stride, y = j·stride (reference motion.py:57-58);
    `row0`, an int or a (B,) tensor, is the global block row of a row band's
    first row.  Summed in int64, so the sums of the bands of a frame add up
    to the frame's; `moments_fit_ok` bounds every sum below 2**31, so the
    values are the JAX package's int32 sums."""
    _, nbh, nbw = inlier_mask.shape
    m = inlier_mask.to(torch.int64)
    x, y = _cell_coords(nbh, nbw, torch.int64, m.device)
    row0 = torch.as_tensor(row0, dtype=torch.int64, device=m.device).reshape(-1, 1, 1)
    x, y = (x + row0) * coord_stride, y * coord_stride
    d0 = motion_field[..., 0].to(torch.int64) * m
    d1 = motion_field[..., 1].to(torch.int64) * m
    mx = m * x
    my = m * y
    terms = [m, mx, my, mx * x, mx * y, my * y,
             d0, d0 * x, d0 * y, d1, d1 * x, d1 * y]
    return torch.stack([t.sum(dim=(1, 2)) for t in terms], dim=-1)


def params_from_moments(moments: torch.Tensor) -> torch.Tensor:
    """Solve the mean-centred affine normal equations from (B, 12) exact
    moments, in the f32 operations XLA:CPU compiles the JAX package's
    function to (each `_fma` one FMA of its object code).  An empty inlier
    set or a singular system gives the JAX package's NaN and inf
    parameters; under `guards.debug_checks()` it raises instead, as the JAX
    package's `guards.check` does.

    The solve runs on the host whatever the moments' device: they are 12
    numbers a pair, and on the card each of its hundred-odd small ops would
    be a launch."""
    dev = moments.device
    mom = moments.cpu().to(torch.float32).T  # (12, B)
    n, Sx, Sy = mom[0], mom[1], mom[2]
    guards.check(n > 0, "affine fit: empty inlier set (all cells masked out)")
    xbar = Sx / n
    ybar = Sy / n
    # Independent terms share one `_fma` call; each element keeps its own
    # operation order.
    Gxx, Gxy, Gyy = _fma(-mom[[1, 1, 2]], torch.stack([xbar, ybar, ybar]), mom[3:6])
    det = _fma(Gxx, Gyy, -(Gxy * Gxy))
    guards.check(det != 0, "affine fit: singular normal equations (inlier cells are collinear)")

    # Both axes at once: row k of Sd, Sxd, Syd is the axis of d_k.
    Sd, Sxd, Syd = mom[[6, 9]], mom[[7, 10]], mom[[8, 11]]
    bx, by = _fma(-torch.stack([xbar, ybar])[:, None], Sd, torch.stack([Sxd, Syd]))
    a1, a2 = _fma(torch.stack([bx, by]), torch.stack([Gyy, Gxx])[:, None],
                  -(torch.stack([by, bx]) * Gxy)) / det
    a0 = _fma(-a2, ybar, _fma(-a1, xbar, Sd / n))
    # [a0, a1, a2, b0, b1, b2] per pair
    return torch.stack([a0, a1, a2], dim=1).reshape(6, -1).T.contiguous().to(dev)


def fit_normal_equations(
    motion_field: torch.Tensor,
    inlier_mask: torch.Tensor,
    frame_shape: Tuple[int, int],
    coord_stride: int = 4,
) -> torch.Tensor:
    """Least-squares affine fit of a (B, nbh, nbw, 2) block field over the
    (B, nbh, nbw) inlier cells (reference motion.py:52-84, 248-282): the
    exact integer-moment path for integer fields within the int32 moment
    bound, else the mean-centred f32 fit."""
    _, nbh, nbw = inlier_mask.shape
    if not motion_field.is_floating_point() and moments_fit_ok(
        nbh, nbw, frame_shape, coord_stride
    ):
        return params_from_moments(
            int_moments(motion_field, inlier_mask, coord_stride)
        )
    return _fit_normal_equations_f32(
        motion_field, inlier_mask, frame_shape, coord_stride
    )


def _fit_normal_equations_f32(
    motion_field: torch.Tensor,
    inlier_mask: torch.Tensor,
    frame_shape: Tuple[int, int],
    coord_stride: int = 4,
) -> torch.Tensor:
    """Mean-centred f32 fit (float fields, or frames whose moments overflow
    int32, such as 1080p).  Its sums run in another order than XLA's, so it
    agrees with the JAX package to float32 rounding, not bit for bit.  An
    empty inlier set gives NaN parameters, as in the JAX package, and raises
    under `guards.debug_checks()`; a singular system gives what the LU
    solve gives, raising nowhere."""
    B, nbh, nbw = inlier_mask.shape
    H, W = frame_shape
    dev = motion_field.device
    w = torch.tensor(1.0 / (H * W), dtype=torch.float32, device=dev)
    xs, ys = _cell_coords(nbh, nbw, torch.float32, dev)
    xs, ys = xs * coord_stride, ys * coord_stride
    mw = inlier_mask.to(torch.float32) * w

    wsum = mw.sum(dim=(1, 2))
    guards.check(wsum > 0, "affine fit: empty inlier set (all cells masked out)")
    xbar = (xs * mw).sum(dim=(1, 2)) / wsum
    ybar = (ys * mw).sum(dim=(1, 2)) / wsum
    xc = xs - xbar[:, None, None]
    yc = ys - ybar[:, None, None]
    A = torch.stack([torch.ones_like(xc), xc, yc], dim=-1)  # (B, nbh, nbw, 3)
    G = torch.einsum("bija,bijc,bij->bac", A, A, mw)
    d = motion_field.to(torch.float32)
    rhs = torch.einsum("bija,bijc,bij->bac", A, d, mw)
    # solve_ex: a singular system is no error, as in jnp.linalg.solve.
    sol = torch.linalg.solve_ex(G, rhs).result  # (B, 3, 2) rows: [c0, a1|b1, a2|b2]
    a0 = sol[:, 0, 0] - sol[:, 1, 0] * xbar - sol[:, 2, 0] * ybar
    b0 = sol[:, 0, 1] - sol[:, 1, 1] * xbar - sol[:, 2, 1] * ybar
    return torch.stack(
        [a0, sol[:, 1, 0], sol[:, 2, 0], b0, sol[:, 1, 1], sol[:, 2, 1]], dim=-1
    )


def outlier_mask(
    gt_motion_field: torch.Tensor,
    affine_field: torch.Tensor,
    outlier_fraction: float = 0.3,
) -> torch.Tensor:
    """(B, nbh, nbw) INLIER mask: cells whose L1 error exceeds the value
    `int(fraction*N)` places from the end of the ascending sort are masked
    (reference motion.py:236-244).  With fraction 0 the index is
    `(n - 0) % n == 0`, the reference's `all_diffs[-0]`: the smallest error."""
    diff = (
        gt_motion_field.to(torch.int32) - affine_field.to(torch.int32)
    ).abs().sum(dim=-1)
    B = diff.shape[0]
    flat = torch.sort(diff.reshape(B, -1), dim=-1).values
    n = flat.shape[1]
    threshold_index = int(outlier_fraction * n)
    threshold_value = flat[:, (n - threshold_index) % n]
    return ~(diff > threshold_value[:, None, None])
