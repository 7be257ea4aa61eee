"""The control of `check.py`: the plain reference with its float32 steps
in bfloat16 (`reference.py`'s `fdt`), put in the place of the program's
step.  The driver then writes the control's answers where it writes the
program's, and the harness's own comparison judges them: a run with the
control in place has to come out not correct.  `limits.py` and the
harness's tests use it; the benchmark's runs do not."""

from __future__ import annotations

import contextlib

import torch

from benchmark import reference


def step(gme: dict, fdt=torch.bfloat16):
    """A function with the program step's signature and outputs, computed
    by the reference in `fdt` under the configuration's `gme` settings."""

    def control(prev, curr, cfg=None):
        out = reference.step(prev, curr, gme, fdt)
        return {
            "parameters": out["parameters"].float(),
            "model_motion_field": out["model_motion_field"].to(torch.int32),
            "compensated": out["compensated"],
            "psnr": out["psnr"].float(),
            "volume_edge_hits": out["volume_edge_hits"].to(torch.int32),
        }

    return control


@contextlib.contextmanager
def in_program_place(fn):
    """Run the driver with `fn` as its per-batch step, on one card and in
    each data slot."""
    import gme_tpu_torch.parallel.data_parallel as dp
    import gme_tpu_torch.pipeline.results as results

    saved = [(m, m.gme_pipeline_batch) for m in (results, dp)]
    try:
        for m, _ in saved:
            m.gme_pipeline_batch = fn
        yield
    finally:
        for m, f in saved:
            m.gme_pipeline_batch = f
