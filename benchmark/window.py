"""The measured window: a closed loop of whole clips, one caller.

The window opens when set-up ends and closes when the first clip that ends
after `seconds` ends, so it holds whole clips only.  `pairs_per_s` is every
pair of every clip finished in it over the window's whole length (each
clip's start-up included, the harness's pauses between clips left out);
`nearest_rank` gives a percentile of the clips' wall times
(`driver.clip_s_p90`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


@dataclass
class Clip:
    start: float
    end: float
    pairs: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    opened: float
    seconds: float
    clips: List[Clip] = field(default_factory=list)
    paused: float = 0.0

    def add(self, start: float, end: float, pairs: int) -> None:
        self.clips.append(Clip(start, end, pairs))

    def pause(self, seconds: float) -> None:
        """Leave `seconds` of the harness's own work between clips out."""
        self.paused += seconds

    @property
    def closed(self) -> bool:
        """Whether the last clip ended at or past `seconds`."""
        return bool(self.clips) and self.length >= self.seconds

    @property
    def length(self) -> float:
        return self.clips[-1].end - self.opened - self.paused

    @property
    def pairs(self) -> int:
        return sum(c.pairs for c in self.clips)

    def pairs_per_s(self) -> float:
        return self.pairs / self.length


def nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile `q` (0-100) of `values`."""
    ranked = sorted(values)
    return ranked[max(0, math.ceil(q / 100 * len(ranked)) - 1)]
