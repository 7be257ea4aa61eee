"""Readings that the limits of `check.py` are set from, for one cell.

    python3 benchmark/limits.py --workload <name> --seconds <s> \
        --seeds 11 12 ... --control-seeds 21 22 23

Each seed is one run of the cell (`run.run_cell`, the benchmark's own run
with its window, sample and comparison) in this one process.  For each of
`--seeds` the program runs: its numbers are the lower readings.  For each
of `--control-seeds` the control (`control.py`: the reference in bfloat16)
runs in the place of the program's step, and the same comparison judges
it: its numbers are the upper readings, and it has to come out not
correct.  One JSON line a seed, on the card the cell names.  The
benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import control, run, spec  # noqa: E402


def readings(cell: spec.Cell, seconds: float, seeds, control_seeds, device=None):
    """Yield one dict a seed: {"seed", "side", "correct", "failed",
    readings...}."""
    import torch

    for side, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        step = control.step(cell.config["gme"], torch.bfloat16) if side == "control" else None
        t0 = time.perf_counter()
        if step is None:
            rc, result, _ = run.run_cell(cell, seed, seconds, False, device=device, t0=t0)
        else:
            with control.in_program_place(step):
                rc, result, _ = run.run_cell(cell, seed, seconds, False, device=device, t0=t0)
        yield {"seed": seed, "side": side, "rc": rc, "correct": result["correct"],
               "attempted": result["attempted"], "failed": result["failed"],
               **{k: v["value"] for k, v in result["checks"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    for r in readings(cell, args.seconds, args.seeds, args.control_seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
