"""Data parallelism over frame pairs.

Counterpart of `gme_tpu/parallel/data_parallel.py`: the pair batch splits
over the mesh's "data" slots and each slot runs `gme_pipeline_batch` on its
share.  Pairs are independent and every output of the step is exact per
pair (the PSNR from an exact integer sum), so the result equals the
single-device batch bit for bit.  The slots run one after the other from
this process.
"""

from __future__ import annotations

from typing import Dict

import torch

from gme_tpu_torch.config import GMEConfig
from gme_tpu_torch.models.gme import gme_pipeline_batch
from gme_tpu_torch.parallel.mesh import Mesh


def make_sharded_pipeline(mesh: Mesh, cfg: GMEConfig):
    """The batched step with the pair axis split over "data": (prev, curr)
    (B, H, W) uint8, B a multiple of the data size -> the dict of
    `gme_pipeline_batch`, on the first slot's device."""
    slots = [row[0] for row in mesh.devices]

    def step(prev_batch: torch.Tensor, curr_batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = prev_batch.shape[0]
        if B % len(slots):
            raise ValueError(f"batch {B} must divide by mesh data={len(slots)}")
        n = B // len(slots)
        outs = [
            gme_pipeline_batch(prev_batch[i * n:(i + 1) * n].to(dev),
                               curr_batch[i * n:(i + 1) * n].to(dev), cfg)
            for i, dev in enumerate(slots)
        ]
        return {k: torch.cat([o[k].to(slots[0]) for o in outs]) for k in outs[0]}

    return step
