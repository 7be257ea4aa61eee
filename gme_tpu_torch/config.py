"""Configuration of the PyTorch port.

The same frozen dataclass as `gme_tpu.config.GMEConfig`: the same fields,
defaults and `fast()`.  The system has no learned weights, so this config is
its whole state; `GMEConfig.from_dict(dataclasses.asdict(jax_cfg))` carries
it across from the JAX package without importing it (importing `gme_tpu`
loads JAX).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

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
    # "auto" and "volume" both select the volume engine on every device;
    # the gather engine is not ported yet (ROADMAP A9).
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

    def replace(self, **kw) -> "GMEConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "GMEConfig":
        """Build from `dataclasses.asdict()` of a `gme_tpu` GMEConfig.
        Unknown keys raise, so a field added on one side only is caught."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown GMEConfig fields: {sorted(unknown)}")
        return cls(**d)
