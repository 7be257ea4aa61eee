"""Direct (gradient-descent) global-motion estimation.

Counterpart of `gme_tpu/models/direct.py`, which is the working version of
the reference's three abandoned gradient-descent prototypes (reference
`test scripts/gradient descent tests/`): minimise the photometric error
between the backward-warped previous frame and the current frame over the
parameters of a global motion model.

- The 8-parameter perspective model of the prototype (gd tests/motion.py:
  51-63) and the 6-parameter affine displacement model (motion.py:91-105),
  over the whole pixel grid.
- A differentiable backward warp (bilinear, clamp-to-edge) and the
  photometric mean squared error, differentiated by autograd.
- Normalised coordinates: each level optimises on coordinates divided by
  max(H, W), which puts every parameter on an O(1) scale; the prototype's
  projection rule between levels is then the identity (`project_params`
  keeps it for pixel-unit parameters).
- Coarse to fine over the Gaussian pyramid, a fixed number of Adam steps a
  level under a cosine-decayed learning rate, written out as optax's
  `adam(cosine_decay_schedule(lr, iterations))` computes it.
- The prototype's forward (scatter) warp: the last source pixel in
  row-major order wins a collision, by a scatter-max of the source rank.

Everything runs in plain torch on the device of its inputs: in the JAX
package it is plain XLA, with no Pallas kernel.  The functions take one
(H, W) frame pair, as the JAX ones do.

Differentiation follows XLA's: `jnp.clip` is a max and a min, and a tie
at a bound gives each side half the gradient.  `torch.maximum` and
`torch.minimum` split ties the same way (`torch.clamp` would pass all of
it), and at the identity every border pixel of `bilinear_sample` sits on a
bound.  Float -> int conversions follow XLA's convert: truncation toward
zero, saturation, NaN -> 0 (`torch`'s own conversion of NaN or of an
out-of-range value is undefined).

Directionality: estimated parameters map CURRENT-frame coordinates to
PREVIOUS-frame coordinates (`warp_backward(previous, params)` rebuilds the
current frame); `warp_forward` expects the inverse mapping.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gme_tpu_torch.ops.pyramid import get_pyramids

N_MAX_ITERATIONS = 100  # the prototype's budget, reference gd tests/motion.py:6
DEFAULT_ITERATIONS = 300  # per level
# Peak Adam step in normalised-coordinate units, cosine-decayed to 0 within
# each level.
DEFAULT_LEARNING_RATE = 0.01

# optax.adam's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8

# ---------------------------------------------------------------------------
# Motion models
# ---------------------------------------------------------------------------


def perspective_model(params: torch.Tensor, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mapped coordinates under the 8-parameter perspective model
    (gd tests/motion.py:51-63, without its int() truncation); the
    denominator is kept away from zero by a signed 1e-6."""
    p = params
    den = p[6] * x + p[7] * y + 1.0
    tiny = torch.where(den < 0, -1e-6, 1e-6)
    den = torch.where(den.abs() < 1e-6, tiny, den)
    x1 = (p[0] + p[2] * x + p[3] * y) / den
    y1 = (p[1] + p[4] * x + p[5] * y) / den
    return x1, y1


def affine_coords(params: torch.Tensor, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mapped coordinates under the 6-parameter affine DISPLACEMENT model
    (reference motion.py:91-105): source = coord + displacement."""
    p = params
    x1 = x + p[0] + p[1] * x + p[2] * y
    y1 = y + p[3] + p[4] * x + p[5] * y
    return x1, y1


def identity_params(model: str, device=None) -> torch.Tensor:
    """Parameters mapping every pixel to itself (perspective: a2 = a5 = 1,
    gd tests/motion.py:46)."""
    if model == "perspective":
        return torch.tensor([0, 0, 1, 0, 0, 1, 0, 0], dtype=torch.float32, device=device)
    if model == "affine":
        return torch.zeros(6, dtype=torch.float32, device=device)
    raise ValueError(f"unknown model {model!r}")


def _scaled(params: torch.Tensor, s) -> torch.Tensor:
    return params * torch.tensor(s, dtype=torch.float32, device=params.device)


def project_params(params: torch.Tensor, model: str) -> torch.Tensor:
    """One pyramid level finer, for PIXEL-unit parameters.  Perspective:
    a0, a1 *= 2 and a6, a7 /= 2 (gd tests/motion.py:95-105); affine: a0,
    b0 *= 2 (motion.py:191-207)."""
    if model == "perspective":
        return _scaled(params, [2, 2, 1, 1, 1, 1, 0.5, 0.5])
    return _scaled(params, [2, 1, 1, 2, 1, 1])


def params_to_pixel(params: torch.Tensor, scale: float, model: str) -> torch.Tensor:
    """Normalised-coordinate parameters (coords / scale) -> pixel-coordinate
    parameters (the family of `project_params`, at scale ratio 2)."""
    if model == "perspective":
        return _scaled(params, [scale, scale, 1, 1, 1, 1, 1.0 / scale, 1.0 / scale])
    return _scaled(params, [scale, 1, 1, scale, 1, 1])


def params_from_pixel(params: torch.Tensor, scale: float, model: str) -> torch.Tensor:
    """Inverse of `params_to_pixel`."""
    return params_to_pixel(params, 1.0 / scale, model)


def _model_coords(model: str, params, x, y):
    if model == "perspective":
        return perspective_model(params, x, y)
    return affine_coords(params, x, y)


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) float32 row and column coordinates."""
    xs = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    ys = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return xs, ys


def _to_int(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """XLA's float -> int32 convert (truncation, NaN -> 0) of `v` for a
    caller that clips the result into [lo, hi]: clamping to [lo - 1, hi + 1]
    first changes no clipped result and keeps the conversion defined."""
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return v.clamp(lo - 1.0, hi + 1.0).to(torch.int32)


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------


def _clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with XLA's gradient: half at a tie with a bound.  The
    bounds are 0-dim CPU tensors, which a CUDA elementwise op reads as
    scalars: no copy to the card, so no wait for it."""
    lo_t = torch.tensor(lo, dtype=torch.float32)
    hi_t = torch.tensor(hi, dtype=torch.float32)
    return torch.minimum(torch.maximum(v, lo_t), hi_t)


def bilinear_sample(img: torch.Tensor, x, y) -> torch.Tensor:
    """Bilinear lookup img[x, y] with clamp-to-edge (x = row coordinate, as
    in gd tests/motion.py:66-80).  The continuous coordinates are clamped
    before the floor split, so an out-of-frame sample is the edge pixel."""
    H, W = img.shape
    img = img.to(torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=img.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=img.device)
    x = _clip(x, 0.0, H - 1.0)
    y = _clip(y, 0.0, W - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = _to_int(x0, 0, H - 1).clamp(0, H - 1)
    x1i = (x0i + 1).clamp(0, H - 1)
    y0i = _to_int(y0, 0, W - 1).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, W - 1)
    flat = img.reshape(-1)

    def at(r, c):
        return flat[(r * W + c).long()]

    return (
        at(x0i, y0i) * (1 - fx) * (1 - fy)
        + at(x0i, y1i) * (1 - fx) * fy
        + at(x1i, y0i) * fx * (1 - fy)
        + at(x1i, y1i) * fx * fy
    )


def warp_backward(
    frame: torch.Tensor, params: torch.Tensor, model: str = "perspective"
) -> torch.Tensor:
    """Differentiable backward warp: out[i, j] = frame[model(i, j)]
    (bilinear), float32.  `params` are pixel-unit."""
    H, W = frame.shape
    xs, ys = _grid(H, W, frame.device)
    x1, y1 = _model_coords(model, params, xs, ys)
    return bilinear_sample(frame, x1, y1)


def warp_forward(
    frame: torch.Tensor, params: torch.Tensor, model: str = "perspective"
) -> torch.Tensor:
    """Forward (scatter) warp with the prototype's semantics (gd tests/
    motion.py:66-80): source pixel (i, j) goes to its truncated mapped
    coordinate, clamped into the frame; destinations nothing maps to stay 0;
    among colliding sources the last in row-major order wins, by a
    scatter-max of the int32 row-major rank (deterministic on the card too).
    Expects a previous -> current mapping (module docstring)."""
    H, W = frame.shape
    dev = frame.device
    xs, ys = _grid(H, W, dev)
    x1, y1 = _model_coords(model, params, xs, ys)
    xd = _to_int(x1, 0, H - 1).clamp(0, H - 1)
    yd = _to_int(y1, 0, W - 1).clamp(0, W - 1)
    rank = torch.arange(H * W, dtype=torch.int32, device=dev)
    win = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    win.scatter_reduce_(0, (xd * W + yd).reshape(-1).long(), rank, reduce="amax")
    val = torch.round(frame.to(torch.float32)).clamp(0, 255).to(torch.int32).reshape(-1)
    out = val[win.clamp(0, H * W - 1).long()]
    return torch.where(win < 0, 0, out).reshape(H, W).to(frame.dtype)


# ---------------------------------------------------------------------------
# Direct estimation
# ---------------------------------------------------------------------------


def photometric_loss(
    params: torch.Tensor,
    previous: torch.Tensor,
    current: torch.Tensor,
    model: str,
    coord_scale: float = 1.0,
) -> torch.Tensor:
    """Mean squared photometric error between the backward-warped previous
    frame and the current frame (the SSD of gd tests/motion.py:9-23 over
    the pixel count).  `params` are in normalised coordinates when
    `coord_scale` > 1 (coords / scale).  The mean is the sum times the
    float32 reciprocal of the count, as `jnp.mean` compiles (a 0-dim CPU
    tensor, read as a scalar on the card)."""
    H, W = previous.shape
    xs, ys = _grid(H, W, previous.device)
    x1, y1 = _model_coords(model, params, xs * (1.0 / coord_scale), ys * (1.0 / coord_scale))
    warped = bilinear_sample(previous, x1 * coord_scale, y1 * coord_scale)
    err = warped - current.to(torch.float32)
    inv_n = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(H * W), dtype=torch.float32)
    return (err * err).sum() * inv_n


def _schedule(learning_rate: float, iterations: int) -> torch.Tensor:
    """(iterations, 3) float32: per step t, the learning rate of
    optax.cosine_decay_schedule(learning_rate, iterations) (alpha 0) at
    count t, and Adam's bias corrections 1 - b1**(t+1) and 1 - b2**(t+1),
    each in float32 operations as optax computes them."""
    t = torch.arange(iterations, dtype=torch.float32)
    count = torch.minimum(t, torch.tensor(float(iterations)))
    lr = learning_rate * (0.5 * (1 + torch.cos(math.pi * count / iterations)))
    b1 = torch.tensor(_B1, dtype=torch.float32)
    b2 = torch.tensor(_B2, dtype=torch.float32)
    return torch.stack([lr, 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)], dim=1)


def optimize_level(
    params: torch.Tensor,
    previous: torch.Tensor,
    current: torch.Tensor,
    model: str = "perspective",
    iterations: int = DEFAULT_ITERATIONS,
    learning_rate: float = DEFAULT_LEARNING_RATE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iterations` Adam steps on the photometric loss at one level, the
    learning rate cosine-decayed to 0 over them.  `params` are
    NORMALISED-coordinate parameters (coords / max(H, W)).

    Adam is optax's: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias correction from t = 1.  The step's scalars go to the device once
    (`_schedule`), so the loop never waits for the host.  Returns (params,
    losses), `losses[t]` the loss before update t, as the JAX `lax.scan`
    returns them."""
    dev = previous.device
    prev_f = previous.to(torch.float32)
    curr_f = current.to(torch.float32)
    scale = float(max(previous.shape))
    sched = _schedule(learning_rate, iterations).to(dev)
    p = params.detach().to(torch.float32).clone()
    mu = torch.zeros_like(p)
    nu = torch.zeros_like(p)
    losses = []
    for t in range(iterations):
        p.requires_grad_(True)
        loss = photometric_loss(p, prev_f, curr_f, model, scale)
        (g,) = torch.autograd.grad(loss, p)
        p = p.detach()
        losses.append(loss.detach())
        lr, bc1, bc2 = sched[t]
        mu = (1 - _B1) * g + _B1 * mu
        nu = (1 - _B2) * (g * g) + _B2 * nu
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
        p = p + (-lr) * update
    losses = torch.stack(losses) if losses else torch.zeros(0, device=dev)
    return p, losses


def _pyramid(frame: torch.Tensor, levels: int):
    """The Gaussian pyramid of one (H, W) frame, coarsest first."""
    return [level[0] for level in get_pyramids(frame[None], levels)]


def direct_global_motion_estimation(
    previous: torch.Tensor,
    current: torch.Tensor,
    model: str = "perspective",
    levels: int = 3,
    iterations: int = DEFAULT_ITERATIONS,
    learning_rate: float = DEFAULT_LEARNING_RATE,
) -> torch.Tensor:
    """Coarse-to-fine direct GME (the working version of the prototype's
    `global_motion_estimation`, gd tests/motion.py:150+): identity at the
    coarsest level, then `optimize_level` at each level in normalised
    coordinates.  Returns the (8,) perspective or (6,) affine parameters in
    pixel units at full resolution, mapping current-frame to previous-frame
    coordinates."""
    prev_pyr = _pyramid(previous, levels)
    curr_pyr = _pyramid(current, levels)
    params = identity_params(model, previous.device)
    for lvl in range(levels):
        params, _ = optimize_level(
            params, prev_pyr[lvl], curr_pyr[lvl], model=model,
            iterations=iterations, learning_rate=learning_rate,
        )
    return params_to_pixel(params, float(max(previous.shape)), model)


def direct_motion_compensation(
    previous: torch.Tensor,
    current: torch.Tensor,
    model: str = "perspective",
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot direct estimate and backward compensation: (params,
    compensated uint8 frame), the shape of the one-shot
    `motion_compensation` (reference motion.py:324-341)."""
    params = direct_global_motion_estimation(previous, current, model, **kw)
    comp = warp_backward(previous, params, model)
    return params, torch.round(comp).clamp(0, 255).to(torch.uint8)
