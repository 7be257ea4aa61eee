"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's tests: 96x128 frames, 9-frame clips, 4 pairs a data slot."""

import copy

from benchmark import spec

SEED = 3_000_000_123  # above 2**31: a seed may need more than 32 signed bits


def tiny_cell(workload: str, frames: int = 9, image_sample: int = 4, data: int = None
              ) -> spec.Cell:
    """The cell, cut; `data` sets the mesh's data slots (the CPU in each)."""
    cell = spec.load_cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["frame"] = {"height": 96, "width": 128}
    if data is not None:
        cell.config["pipeline"]["mesh"]["data"] = data
    cell.config["pipeline"]["batch_size"] = 4 * cell.config["pipeline"]["mesh"]["data"]
    per_call = min(cell.traffic["image_pairs_per_call"], image_sample)
    cell.traffic = dict(cell.traffic, frames=frames, image_pairs_per_call=per_call)
    return cell
