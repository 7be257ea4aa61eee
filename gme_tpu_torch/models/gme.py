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


def dense_motion_estimation(previous, current, cfg: GMEConfig = _DEFAULT):
    """Dense init field: block-2 diamond search (reference motion.py:13-30).
    Returns the field and its (B,) `volume_edge_hits`."""
    field, diag = get_motion_field(
        previous, current,
        block_size=cfg.dense_block_size,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.dense_volume_radius,
        return_diagnostics=True,
    )
    return field, diag["volume_edge_hits"]


def best_affine_parameters_robust(
    previous, current, old_parameters, cfg: GMEConfig = _DEFAULT
):
    """Robust fit: block field -> outlier mask against the old parameters'
    affine field -> masked normal equations (reference motion.py:210-286).
    Returns (B, 6) parameters and the (B,) `volume_edge_hits`."""
    gt, diag = get_motion_field(
        previous, current,
        block_size=cfg.block_size,
        searching_procedure=cfg.searching_procedure,
        max_iters=cfg.max_search_iters,
        search_impl=cfg.search_impl,
        volume_radius=cfg.volume_radius,
        return_diagnostics=True,
    )
    affine_field = get_motion_field_affine(gt.shape[1:3], old_parameters)
    inliers = outlier_mask(gt, affine_field, cfg.outlier_fraction)
    params = fit_normal_equations(
        gt, inliers, tuple(previous.shape[1:]), cfg.coord_stride
    )
    return params, diag["volume_edge_hits"]


def global_motion_estimation_with_diagnostics(
    previous: torch.Tensor, current: torch.Tensor, cfg: GMEConfig = _DEFAULT
):
    """(B, 6) float32 affine parameters [a0,a1,a2,b0,b1,b2] of (B, H, W)
    uint8 frame pairs (reference motion.py:109-136), and
    `{"volume_edge_hits": (B,) int32}`: the walks, over the dense init and
    every level, that entered the volume's boundary-adjacent ring."""
    _check_frames(previous, current)
    prev_pyr = get_pyramids(previous, cfg.pyramid_levels)
    curr_pyr = get_pyramids(current, cfg.pyramid_levels)

    field, edge_hits = dense_motion_estimation(prev_pyr[0], curr_pyr[0], cfg)
    parameters = compute_first_parameters(field)
    for i in range(1, cfg.pyramid_levels):
        parameters = parameter_projection(parameters)
        parameters, hits = best_affine_parameters_robust(
            prev_pyr[i], curr_pyr[i], parameters, cfg
        )
        edge_hits = edge_hits + hits
    return parameters, {"volume_edge_hits": edge_hits}


def gme_pipeline_batch(
    previous_batch: torch.Tensor, current_batch: torch.Tensor,
    cfg: GMEConfig = _DEFAULT,
) -> Dict[str, torch.Tensor]:
    """The full results-pipeline step (reference results.py:47-110) on a
    (B, H, W) uint8 batch of frame pairs: GME -> dense affine field ->
    compensation -> diffs -> PSNR.  Outputs carry the leading B."""
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


def gme_pipeline_step(
    previous: torch.Tensor, current: torch.Tensor, cfg: GMEConfig = _DEFAULT
) -> Dict[str, torch.Tensor]:
    """`gme_pipeline_batch` on one (H, W) uint8 pair; outputs without the
    batch dimension."""
    out = gme_pipeline_batch(previous[None], current[None], cfg)
    return {k: v[0] for k, v in out.items()}
