"""Configuration of the PyTorch port.

The same frozen dataclasses as `gme_tpu.config` (`BBMEConfig`,
`GMEConfig`, `MeshConfig`, `PipelineConfig`): the same fields and
defaults.  The system has no learned weights, so these configs are its
whole state; `PipelineConfig.from_dict(dataclasses.asdict(jax_cfg))` (and
the same for each of the others) carries one across from the JAX package
without importing it (importing `gme_tpu` loads JAX).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Searching-procedure indices (reference bbme.py:609-614).
EXHAUSTIVE = 0
THREESTEP = 1
TWODLOG = 2
DIAMOND = 3

# p-norm indices (reference bbme.py:608).
MAE = 0
MSE = 1

SEARCH_NAMES = {
    EXHAUSTIVE: "exhaustive",
    THREESTEP: "threestep",
    TWODLOG: "twodlog",
    DIAMOND: "diamond",
}

PNORM_NAMES = {MAE: "mae", MSE: "mse"}


def _from_dict(cls, d: dict):
    """Build `cls` from `dataclasses.asdict()` of its `gme_tpu` namesake.
    Unknown keys raise, so a field added on one side only is caught."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**d)


@dataclass(frozen=True)
class BBMEConfig:
    """Block-based motion estimation parameters; field-for-field the JAX
    package's `BBMEConfig`, whose defaults are `get_motion_field`'s
    (reference bbme.py:12-19: block 4, window 2, three-step, MSE).
    `search_impl` "auto" and "volume" select the volume engine on every
    device, "gather" the gather engine (`ops/bbme.py`)."""

    block_size: int = 4
    search_window: int = 2
    searching_procedure: int = THREESTEP
    pnorm_distance: int = MSE
    max_search_iters: int = 4096
    search_impl: str = "auto"
    volume_radius: int = 32

    def replace(self, **kw) -> "BBMEConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "BBMEConfig":
        return _from_dict(cls, d)


@dataclass(frozen=True)
class GMEConfig:
    """Global-motion-estimation (affine model) parameters; field-for-field
    the JAX package's `GMEConfig` (see its docstring for each reference
    constant)."""

    block_size: int = 16
    search_window: int = 2
    pyramid_levels: int = 3
    outlier_fraction: float = 0.3
    coord_stride: int = 4
    dense_block_size: int = 2
    searching_procedure: int = DIAMOND
    pnorm_distance: int = MSE
    max_search_iters: int = 4096
    # "auto" and "volume" select the volume engine on every device,
    # "gather" the gather engine (`ops/bbme.py`).
    search_impl: str = "auto"
    volume_radius: int = 32
    dense_volume_radius: int = 16
    fast_volume_radius: int = 12
    fast_dense_volume_radius: int = 8

    def fast(self) -> "GMEConfig":
        """The tight-radius first-tier config of the adaptive dispatch."""
        return self.replace(
            volume_radius=self.fast_volume_radius,
            dense_volume_radius=self.fast_dense_volume_radius,
        )

    def bbme(self, block_size: Optional[int] = None) -> BBMEConfig:
        return BBMEConfig(
            block_size=self.block_size if block_size is None else block_size,
            search_window=self.search_window,
            searching_procedure=self.searching_procedure,
            pnorm_distance=self.pnorm_distance,
            max_search_iters=self.max_search_iters,
            search_impl=self.search_impl,
            volume_radius=self.volume_radius,
        )

    def replace(self, **kw) -> "GMEConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "GMEConfig":
        return _from_dict(cls, d)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout, field-for-field the JAX package's: pairs over
    `data`, frame rows over `space` (`gme_tpu_torch/parallel/`)."""

    data_axis: str = "data"
    space_axis: str = "space"
    data: int = 1
    space: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.space)

    @classmethod
    def from_dict(cls, d: dict) -> "MeshConfig":
        return _from_dict(cls, d)


@dataclass(frozen=True)
class PipelineConfig:
    """The results driver's configuration (reference results.py:11,
    114-138); field-for-field the JAX package's `PipelineConfig`."""

    frame_distance: int = 1
    gme: GMEConfig = dataclasses.field(default_factory=GMEConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Frame pairs per step call.
    batch_size: int = 8
    # Skip frame indices whose records already exist (the results directory
    # is the restart ledger).
    resume: bool = False
    write_images: bool = True
    # Escape-guarded adaptive volume radius (models.gme
    # .gme_pipeline_batch_adaptive): equal to the full-radius run by
    # construction.  Mesh 1x1 only.
    adaptive: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        """From `dataclasses.asdict()` of the JAX package's PipelineConfig:
        the nested `gme` and `mesh` dicts become their configs."""
        d = dict(d)
        if isinstance(d.get("gme"), dict):
            d["gme"] = GMEConfig.from_dict(d["gme"])
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig.from_dict(d["mesh"])
        return _from_dict(cls, d)
