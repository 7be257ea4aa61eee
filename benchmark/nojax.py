"""The check that nothing in the process loaded JAX or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, taken whole: `gme_tpu_torch` begins with `gme_tpu` and is not it."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gme_tpu"})


def loaded(modules: Iterable[str] = None) -> List[str]:
    """Sorted top-level names among `modules` (default: `sys.modules`)
    that are JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in list(names)} & FORBIDDEN)
