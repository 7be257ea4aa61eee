"""gme_tpu_torch — the PyTorch/CUDA port of gme_tpu for one NVIDIA H100.

The per-pair global-motion-estimation step, the block-matching searches and
the results driver of `gme_tpu`, in PyTorch, with hand-written Hopper
kernels (`csrc/`) in place of the JAX package's Pallas kernels.  Every op
takes a leading pair dimension.  The `_jit` entries (and `gme_pipeline_batch`)
are the JAX package's compiled functions: captured CUDA graphs on the card
(`utils/compiled.py`).  The package imports neither `jax` nor
`gme_tpu`; the JAX package is the reference the tests hold it to.
"""

import torch

# Exactness: no float32 matmul or convolution may run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gme_tpu_torch.config import BBMEConfig, GMEConfig, PipelineConfig  # noqa: E402
from gme_tpu_torch.models.gme import (  # noqa: E402
    global_motion_estimation,
    global_motion_estimation_jit,
    gme_pipeline_batch,
    gme_pipeline_batch_eager,
    gme_pipeline_step,
    gme_pipeline_step_jit,
    motion_compensation,
)
from gme_tpu_torch.models.hierarchical_bbme import hierarchical_wrapper  # noqa: E402
from gme_tpu_torch.ops.affine import (  # noqa: E402
    affine_model,
    get_motion_field_affine,
    get_motion_field_affine_jit,
)
from gme_tpu_torch.ops.bbme import (  # noqa: E402
    get_motion_field,
    get_motion_field_cfg,
    get_motion_field_jit,
)
from gme_tpu_torch.ops.metrics import psnr, psnr_jit  # noqa: E402
from gme_tpu_torch.ops.pyramid import get_pyramids, get_pyramids_jit, pyrdown  # noqa: E402
from gme_tpu_torch.ops.warp import compensate_frame, compensate_frame_jit  # noqa: E402

__all__ = [
    "BBMEConfig",
    "GMEConfig",
    "PipelineConfig",
    "affine_model",
    "compensate_frame",
    "compensate_frame_jit",
    "get_motion_field",
    "get_motion_field_affine",
    "get_motion_field_affine_jit",
    "get_motion_field_cfg",
    "get_motion_field_jit",
    "get_pyramids",
    "get_pyramids_jit",
    "global_motion_estimation",
    "global_motion_estimation_jit",
    "gme_pipeline_batch",
    "gme_pipeline_batch_eager",
    "gme_pipeline_step",
    "gme_pipeline_step_jit",
    "hierarchical_wrapper",
    "motion_compensation",
    "psnr",
    "psnr_jit",
    "pyrdown",
]
