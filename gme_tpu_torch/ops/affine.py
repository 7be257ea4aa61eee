"""Affine global-motion model: dense field, least-squares fit, outlier mask.

Counterpart of `gme_tpu/ops/affine.py`, batched over a leading pair
dimension B.  Parameters are (B, 6) float32 [a0, a1, a2, b0, b1, b2] with
displacement d = [a0 + a1*x + a2*y, b0 + b1*x + b2*y] at cell (x=row, y=col)
(reference motion.py:91-105).

Exactness: every float expression keeps the JAX operation order as separate
eager ops, so the port's CPU and CUDA runs agree bit for bit (no op fuses a
multiply and an add into an FMA, and a division by a tensor is an IEEE
division on both).  Against the JAX package two things differ.  XLA turns a
division by a constant count into a multiply by its float32 reciprocal;
`compute_first_parameters` does the same, so the means match exactly.  XLA
on the CPU also contracts `a*b + c` into an FMA inside `jit`; the port does
not, so `params_from_moments` and `affine_model` can differ from JAX by an
ulp (ROADMAP queue C).  A 1-ulp change in a parameter can flip a `.5`
rounding in the int16 field.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _cell_coords(nbh: int, nbw: int, dtype, device):
    xs = torch.arange(nbh, dtype=dtype, device=device)[:, None].expand(nbh, nbw)
    ys = torch.arange(nbw, dtype=dtype, device=device)[None, :].expand(nbh, nbw)
    return xs, ys


def affine_model(x, y, parameters: torch.Tensor) -> torch.Tensor:
    """(B, *x.shape, 2) displacement of positions (x, y) under (B, 6)
    parameters (reference motion.py:91-105)."""
    p = parameters.to(torch.float32).reshape(parameters.shape[:1] + (6,) + (1,) * x.dim())
    d0 = p[:, 0] + p[:, 1] * x + p[:, 2] * y
    d1 = p[:, 3] + p[:, 4] * x + p[:, 5] * y
    return torch.stack([d0, d1], dim=-1)


def get_motion_field_affine(
    shape: Tuple[int, int], parameters: torch.Tensor
) -> torch.Tensor:
    """(B, shape[0], shape[1], 2) int16 field from (B, 6) parameters,
    rounded half to even like Python's round() (reference motion.py:139-157);
    `torch.round` rounds half to even as `jnp.round` does."""
    nbh, nbw = int(shape[0]), int(shape[1])
    xs, ys = _cell_coords(nbh, nbw, torch.float32, parameters.device)
    return torch.round(affine_model(xs, ys, parameters)).to(torch.int16)


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
    motion_field: torch.Tensor, inlier_mask: torch.Tensor, coord_stride: int = 4
) -> torch.Tensor:
    """(B, 12) exact integer moment sums of the normal equations over inlier
    cells: [n, Σx, Σy, Σxx, Σxy, Σyy, Σd0, Σx·d0, Σy·d0, Σd1, Σx·d1, Σy·d1]
    with x = i·stride, y = j·stride (reference motion.py:57-58).  Summed in
    int64; `moments_fit_ok` bounds every sum below 2**31, so the values are
    the JAX package's int32 sums."""
    _, nbh, nbw = inlier_mask.shape
    m = inlier_mask.to(torch.int64)
    x, y = _cell_coords(nbh, nbw, torch.int64, m.device)
    x, y = x * coord_stride, y * coord_stride
    d0 = motion_field[..., 0].to(torch.int64) * m
    d1 = motion_field[..., 1].to(torch.int64) * m
    mx = m * x
    my = m * y
    terms = [m, mx, my, mx * x, mx * y, my * y,
             d0, d0 * x, d0 * y, d1, d1 * x, d1 * y]
    return torch.stack([t.sum(dim=(1, 2)) for t in terms], dim=-1)


def params_from_moments(moments: torch.Tensor) -> torch.Tensor:
    """Solve the mean-centred affine normal equations from (B, 12) exact
    moments, in the JAX package's f32 operation order.  Raises on an empty
    inlier set or a singular system (the JAX package's `guards.check`)."""
    mom = moments.to(torch.float32)
    n, Sx, Sy, Sxx, Sxy, Syy = (mom[:, i] for i in range(6))
    xbar = Sx / n
    ybar = Sy / n
    Gxx = Sxx - Sx * xbar
    Gxy = Sxy - Sx * ybar
    Gyy = Syy - Sy * ybar
    det = Gxx * Gyy - Gxy * Gxy
    if bool(((n <= 0) | (det == 0)).any()):
        raise ValueError(
            "affine fit: empty inlier set or singular normal equations "
            "(inlier cells are collinear)"
        )

    def axis_params(Sd, Sxd, Syd):
        bx = Sxd - xbar * Sd
        by = Syd - ybar * Sd
        a1 = (bx * Gyy - by * Gxy) / det
        a2 = (by * Gxx - bx * Gxy) / det
        a0 = Sd / n - a1 * xbar - a2 * ybar
        return a0, a1, a2

    a0, a1, a2 = axis_params(mom[:, 6], mom[:, 7], mom[:, 8])
    b0, b1, b2 = axis_params(mom[:, 9], mom[:, 10], mom[:, 11])
    return torch.stack([a0, a1, a2, b0, b1, b2], dim=-1)


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
    agrees with the JAX package to float32 rounding, not bit for bit."""
    B, nbh, nbw = inlier_mask.shape
    H, W = frame_shape
    dev = motion_field.device
    w = torch.tensor(1.0 / (H * W), dtype=torch.float32, device=dev)
    xs, ys = _cell_coords(nbh, nbw, torch.float32, dev)
    xs, ys = xs * coord_stride, ys * coord_stride
    mw = inlier_mask.to(torch.float32) * w

    wsum = mw.sum(dim=(1, 2))
    if bool((wsum <= 0).any()):
        raise ValueError("affine fit: empty inlier set (all cells masked out)")
    xbar = (xs * mw).sum(dim=(1, 2)) / wsum
    ybar = (ys * mw).sum(dim=(1, 2)) / wsum
    xc = xs - xbar[:, None, None]
    yc = ys - ybar[:, None, None]
    A = torch.stack([torch.ones_like(xc), xc, yc], dim=-1)  # (B, nbh, nbw, 3)
    G = torch.einsum("bija,bijc,bij->bac", A, A, mw)
    d = motion_field.to(torch.float32)
    rhs = torch.einsum("bija,bijc,bij->bac", A, d, mw)
    sol = torch.linalg.solve(G, rhs)  # (B, 3, 2) rows: [c0, a1|b1, a2|b2]
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
