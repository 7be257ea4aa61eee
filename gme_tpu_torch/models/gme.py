"""Hierarchical affine global-motion estimation: the per-pair step.

Counterpart of `gme_tpu/models/gme.py`.  Where the JAX package vmaps one
pair's step over a batch, every function here takes the (B, H, W) uint8
batch directly, so a batch is one launch sequence.

Level schedule (reference motion.py:122-134): a 3-level pyramid, coarsest
first; a translation-only init from a dense block-2 diamond search at the
coarsest level; then at each finer level parameter projection and a robust
re-fit with 30% outlier rejection.  As in the JAX package, the motion
searches use MSE whatever `cfg.pnorm_distance` says (the reference GME path
never passes its p-norm to the search).
"""

from __future__ import annotations

from typing import Dict

import torch

from gme_tpu_torch.config import GMEConfig
from gme_tpu_torch.ops.affine import (
    compute_first_parameters,
    fit_normal_equations,
    get_motion_field_affine,
    outlier_mask,
    parameter_projection,
)
from gme_tpu_torch.ops.bbme import get_motion_field
from gme_tpu_torch.ops.metrics import frame_difference, psnr
from gme_tpu_torch.ops.pyramid import get_pyramids
from gme_tpu_torch.ops.warp import compensate_frame
from gme_tpu_torch.utils.compiled import compiled

_DEFAULT = GMEConfig()


def _check_frames(previous: torch.Tensor, current: torch.Tensor) -> None:
    for name, t in (("previous", previous), ("current", current)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 or t.dim() != 3:
            raise ValueError(f"{name}: expected a (B, H, W) uint8 tensor")
    if previous.shape != current.shape or previous.device != current.device:
        raise ValueError(
            f"frame batches differ: {tuple(previous.shape)} on {previous.device} "
            f"vs {tuple(current.shape)} on {current.device}"
        )


def dense_motion_estimation(
    previous, current, cfg: GMEConfig = _DEFAULT, return_diagnostics: bool = False
):
    """Dense init field: a block-2 search, diamond by default (reference
    motion.py:13-30).  With `return_diagnostics` also
    `{"volume_edge_hits": (B,) int32}`."""
    return get_motion_field(
        previous, current,
        block_size=cfg.dense_block_size,
        search_window=cfg.search_window,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.dense_volume_radius,
        return_diagnostics=return_diagnostics,
    )


def first_parameter_estimation(previous, current, cfg: GMEConfig = _DEFAULT):
    """(B, 6) translation-only first estimate (reference motion.py:160-173)."""
    return compute_first_parameters(dense_motion_estimation(previous, current, cfg))


def _level_field(previous, current, cfg: GMEConfig, return_diagnostics: bool = False):
    """The block field of one pyramid level at `cfg.block_size`."""
    return get_motion_field(
        previous, current,
        block_size=cfg.block_size,
        search_window=cfg.search_window,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.volume_radius,
        return_diagnostics=return_diagnostics,
    )


def best_affine_parameters(previous, current, cfg: GMEConfig = _DEFAULT):
    """(B, 6) non-robust closed-form fit over every cell (reference
    motion.py:33-88)."""
    gt = _level_field(previous, current, cfg)
    inliers = torch.ones(gt.shape[:3], dtype=torch.bool, device=gt.device)
    return fit_normal_equations(gt, inliers, tuple(previous.shape[1:]), cfg.coord_stride)


def best_affine_parameters_robust(
    previous, current, old_parameters, cfg: GMEConfig = _DEFAULT,
    return_diagnostics: bool = False,
):
    """Robust fit: block field -> outlier mask against the old parameters'
    affine field -> masked normal equations (reference motion.py:210-286).
    (B, 6) parameters; with `return_diagnostics` also
    `{"volume_edge_hits": (B,) int32}`."""
    out = _level_field(previous, current, cfg, return_diagnostics)
    gt, diag = out if return_diagnostics else (out, None)
    affine_field = get_motion_field_affine(gt.shape[1:3], old_parameters)
    inliers = outlier_mask(gt, affine_field, cfg.outlier_fraction)
    params = fit_normal_equations(
        gt, inliers, tuple(previous.shape[1:]), cfg.coord_stride
    )
    if return_diagnostics:
        return params, diag
    return params


def global_motion_estimation(previous, current, cfg: GMEConfig = _DEFAULT):
    """(B, 6) float32 parameters [a0,a1,a2,b0,b1,b2] of (B, H, W) uint8
    frame pairs: coarse-to-fine robust affine GME (reference
    motion.py:109-136)."""
    return global_motion_estimation_with_diagnostics(previous, current, cfg)[0]


def global_motion_estimation_with_diagnostics(
    previous: torch.Tensor, current: torch.Tensor, cfg: GMEConfig = _DEFAULT
):
    """`global_motion_estimation` and `{"volume_edge_hits": (B,) int32}`:
    the walks, over the dense init and every level, that entered the
    volume's boundary-adjacent ring."""
    _check_frames(previous, current)
    prev_pyr = get_pyramids(previous, cfg.pyramid_levels)
    curr_pyr = get_pyramids(current, cfg.pyramid_levels)

    field, diag = dense_motion_estimation(
        prev_pyr[0], curr_pyr[0], cfg, return_diagnostics=True
    )
    edge_hits = diag["volume_edge_hits"]
    parameters = compute_first_parameters(field)
    for i in range(1, cfg.pyramid_levels):
        parameters = parameter_projection(parameters)
        parameters, diag = best_affine_parameters_robust(
            prev_pyr[i], curr_pyr[i], parameters, cfg, return_diagnostics=True
        )
        edge_hits = edge_hits + diag["volume_edge_hits"]
    return parameters, {"volume_edge_hits": edge_hits}


def motion_compensation(previous, current, cfg: GMEConfig = _DEFAULT):
    """One-shot GME and warp of the previous frames (reference
    motion.py:324-341): (B, H, W) uint8."""
    parameters = global_motion_estimation(previous, current, cfg)
    _, H, W = previous.shape
    field = get_motion_field_affine((H // cfg.block_size, W // cfg.block_size), parameters)
    return compensate_frame(previous, field)


def gme_pipeline_batch_eager(
    previous_batch: torch.Tensor, current_batch: torch.Tensor,
    cfg: GMEConfig = _DEFAULT,
) -> Dict[str, torch.Tensor]:
    """The full results-pipeline step (reference results.py:47-110) on a
    (B, H, W) uint8 batch of frame pairs: GME -> dense affine field ->
    compensation -> diffs -> PSNR.  Outputs carry the leading B.  Run
    op by op; `gme_pipeline_batch` is its compiled form."""
    parameters, diag = global_motion_estimation_with_diagnostics(
        previous_batch, current_batch, cfg
    )
    _, H, W = previous_batch.shape
    model_motion_field = get_motion_field_affine(
        (H // cfg.block_size, W // cfg.block_size), parameters
    )
    compensated = compensate_frame(previous_batch, model_motion_field)
    return {
        "parameters": parameters,
        "model_motion_field": model_motion_field,
        "compensated": compensated,
        "diff_curr_prev": frame_difference(current_batch, previous_batch),
        "diff_curr_comp": frame_difference(current_batch, compensated),
        "psnr": psnr(current_batch, compensated),
        "volume_edge_hits": diag["volume_edge_hits"],
    }


# The JAX package's compiled entry points (JAX models/gme.py:174-203): one
# captured CUDA graph per (cfg, shapes, device) on the card, the eager body
# on the CPU (`utils/compiled.py`).
gme_pipeline_batch = compiled(gme_pipeline_batch_eager, static_argnames=("cfg",))


def gme_pipeline_step(
    previous: torch.Tensor, current: torch.Tensor, cfg: GMEConfig = _DEFAULT
) -> Dict[str, torch.Tensor]:
    """`gme_pipeline_batch` on one (H, W) uint8 pair; outputs without the
    batch dimension."""
    out = gme_pipeline_batch(previous[None], current[None], cfg)
    return {k: v[0] for k, v in out.items()}


gme_pipeline_step_jit = compiled(gme_pipeline_step, static_argnames=("cfg",))
global_motion_estimation_jit = compiled(global_motion_estimation, static_argnames=("cfg",))


def _merge_adaptive_eager(fast_out, full_out, escaped: torch.Tensor):
    """Per-pair select: the full-radius outputs where the fast tier's walk
    entered the volume's boundary ring, the fast outputs elsewhere."""

    def pick(a_full, a_fast):
        sel = escaped.reshape(escaped.shape[:1] + (1,) * (a_fast.dim() - 1))
        return torch.where(sel, a_full, a_fast)

    return {k: pick(full_out[k], fast_out[k]) for k in full_out}


_merge_adaptive = compiled(_merge_adaptive_eager)


def gme_pipeline_batch_adaptive(
    previous_batch: torch.Tensor, current_batch: torch.Tensor,
    cfg: GMEConfig = _DEFAULT,
) -> Dict[str, torch.Tensor]:
    """Escape-guarded adaptive volume radius (JAX models/gme.py:205-228).

    The batch first runs at the tight radii of `cfg.fast()`.  Pairs whose
    diamond walk entered the tight volume's boundary ring (per-pair
    `volume_edge_hits` > 0, the certificate of `diamond_walk_volume`) are
    recomputed at the full radii and merged per pair, so the result equals
    `gme_pipeline_batch(cfg)`.  The certificate is read on the host once,
    as in the JAX package; the full tier runs only if some pair escaped.
    Each tier is one compiled batch step, and the merge is compiled."""
    fast_out = gme_pipeline_batch(previous_batch, current_batch, cfg.fast())
    escaped = fast_out["volume_edge_hits"] > 0
    if not bool(escaped.any()):
        return fast_out
    full_out = gme_pipeline_batch(previous_batch, current_batch, cfg)
    return _merge_adaptive(fast_out, full_out, escaped)
