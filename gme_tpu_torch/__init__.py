"""gme_tpu_torch — the PyTorch/CUDA port of gme_tpu for one NVIDIA H100.

The per-pair global-motion-estimation step and the block-matching searches
of `gme_tpu`, in PyTorch, with hand-written Hopper kernels (`csrc/`) in
place of the JAX package's Pallas kernels.  Every op takes a leading pair
dimension.  The package imports neither `jax` nor `gme_tpu`; the JAX package
is the reference the tests hold it to.
"""

import torch

# Exactness: no float32 matmul or convolution may run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gme_tpu_torch.config import BBMEConfig, GMEConfig  # noqa: E402
from gme_tpu_torch.models.gme import gme_pipeline_batch, gme_pipeline_step  # noqa: E402
from gme_tpu_torch.models.hierarchical_bbme import hierarchical_wrapper  # noqa: E402
from gme_tpu_torch.ops.bbme import get_motion_field, get_motion_field_cfg  # noqa: E402
from gme_tpu_torch.ops.metrics import psnr  # noqa: E402
from gme_tpu_torch.ops.pyramid import get_pyramids  # noqa: E402
from gme_tpu_torch.ops.warp import compensate_frame  # noqa: E402

__all__ = [
    "BBMEConfig",
    "GMEConfig",
    "compensate_frame",
    "get_motion_field",
    "get_motion_field_cfg",
    "get_pyramids",
    "gme_pipeline_batch",
    "gme_pipeline_step",
    "hierarchical_wrapper",
    "psnr",
]
