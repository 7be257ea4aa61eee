"""gme_tpu_torch — the PyTorch/CUDA port of gme_tpu for one NVIDIA H100.

The per-pair global-motion-estimation step, the block-matching searches and
the results driver of `gme_tpu`, in PyTorch, with hand-written Hopper
kernels (`csrc/`) in place of the JAX package's Pallas kernels.  Every op
takes a leading pair dimension.  The package imports neither `jax` nor
`gme_tpu`; the JAX package is the reference the tests hold it to.
"""

import torch

# Exactness: no float32 matmul or convolution may run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gme_tpu_torch.config import BBMEConfig, GMEConfig, PipelineConfig  # noqa: E402
from gme_tpu_torch.models.gme import (  # noqa: E402
    global_motion_estimation,
    gme_pipeline_batch,
    gme_pipeline_step,
    motion_compensation,
)
from gme_tpu_torch.models.hierarchical_bbme import hierarchical_wrapper  # noqa: E402
from gme_tpu_torch.ops.affine import affine_model, get_motion_field_affine  # noqa: E402
from gme_tpu_torch.ops.bbme import get_motion_field, get_motion_field_cfg  # noqa: E402
from gme_tpu_torch.ops.metrics import psnr  # noqa: E402
from gme_tpu_torch.ops.pyramid import get_pyramids, pyrdown  # noqa: E402
from gme_tpu_torch.ops.warp import compensate_frame  # noqa: E402

__all__ = [
    "BBMEConfig",
    "GMEConfig",
    "PipelineConfig",
    "affine_model",
    "compensate_frame",
    "get_motion_field",
    "get_motion_field_affine",
    "get_motion_field_cfg",
    "get_pyramids",
    "global_motion_estimation",
    "gme_pipeline_batch",
    "gme_pipeline_step",
    "hierarchical_wrapper",
    "motion_compensation",
    "psnr",
    "pyrdown",
]
