"""The comparison that decides `correct`: the control comes out as not
correct, and a run with the timed path broken underneath comes out false,
once for each fault a cell of this system can have."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, clips, control, reference, run
from benchmark.tests.tiny import SEED, tiny_cell


def test_reference_equals_the_port_at_a_small_size():
    """The plain reference and the port's step on the CPU: the same fields,
    compensated frames and edge hits, PSNR within float32 rounding."""
    from gme_tpu_torch.config import GMEConfig
    from gme_tpu_torch.models.gme import gme_pipeline_batch_eager

    cfg = GMEConfig()
    for step, seed in (((3, -5), 1), ((-2, 7), 2)):
        fr = torch.from_numpy(clips.synthetic_pan(5, 96, 128, step, seed))
        port = gme_pipeline_batch_eager(fr[:-1], fr[1:], cfg)
        ref = reference.step(fr[:-1], fr[1:], dataclasses.asdict(cfg))
        assert torch.equal(port["model_motion_field"].long(), ref["model_motion_field"])
        assert torch.equal(port["compensated"], ref["compensated"])
        assert torch.equal(port["volume_edge_hits"].long(), ref["volume_edge_hits"])
        assert (port["psnr"].double() - ref["psnr"]).abs().max() < 1e-5


def test_edge_hits_count_walks_that_reach_the_ring():
    """A pan of 3 px a frame at radius 2: every walk that moves reaches the
    ring (|offset| >= 1), and radius 8 sees none of them there."""
    fr = torch.from_numpy(clips.synthetic_pan(2, 64, 64, (3, 3), 4)).long()
    _, hits = reference.diamond_search(fr[:1], fr[1:], 16, 2, 4096)
    _, none = reference.diamond_search(fr[:1], fr[1:], 16, 8, 4096)
    assert int(hits[0]) > 0 and int(none[0]) == 0


@pytest.mark.parametrize("workload", ["gme720.noimg", "gme240.img"])
def test_control_is_not_correct(workload):
    """The reference with its float32 steps in bfloat16, run in the place
    of the program's step, comes out not correct by the harness's own
    comparison, on three seeds (on the chip at the cells' own sizes too:
    PERF.md)."""
    cell = tiny_cell(workload)
    step = control.step(cell.config["gme"], torch.bfloat16)
    for seed in (SEED, SEED + 1, SEED + 2):
        with control.in_program_place(step):
            rc, result, lines = run.run_cell(cell, seed, 0.5, False, device="cpu")
        assert rc == 0
        assert result["correct"] is False, lines
        checks = result["checks"]
        assert checks["psnr_gap_db"]["value"] > checks["psnr_gap_db"]["limit"], lines
        assert checks["missing_pairs"]["value"] == 0


def test_control_in_float32_is_correct():
    """The same path with the reference in float32 in the program's place
    comes out correct: the control fails by its precision alone."""
    cell = tiny_cell("gme240.img")
    with control.in_program_place(control.step(cell.config["gme"], torch.float32)):
        rc, result, lines = run.run_cell(cell, SEED, 0.5, False, device="cpu")
    assert rc == 0 and result["correct"] is True, lines


def _broken(monkeypatch, fault):
    """A context in which the timed path has `fault` underneath."""
    import gme_tpu_torch.parallel.data_parallel as dp
    import gme_tpu_torch.pipeline.results as results

    step = results.gme_pipeline_batch

    def altered(prev, curr, cfg):  # one answer altered where it is produced
        out = dict(step(prev, curr, cfg))
        out["psnr"] = out["psnr"].clone()
        out["psnr"][0] += 0.01
        return out

    def half(prev, curr, cfg):  # half of the batch left out, the rest repeated
        n = prev.shape[0] // 2
        out = step(prev[:n], curr[:n], cfg)
        return {k: torch.cat([v, v[: prev.shape[0] - n]]) for k, v in out.items()}

    if fault in ("altered", "half"):  # one card's step, and each data slot's
        return control.in_program_place(altered if fault == "altered" else half)
    else:  # the exchange between the data slots left out

        def no_exchange(mesh, cfg):
            slots = [row[0] for row in mesh.devices]

            def body(prev, curr):
                n = prev.shape[0] // len(slots)
                outs = [step(prev[:n], curr[:n], cfg) for _ in slots]  # slot 0's share only
                return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

            return body

        monkeypatch.setattr(dp, "make_sharded_pipeline", no_exchange)
        return contextlib.nullcontext()


@pytest.mark.parametrize("workload,data,fault", [
    ("gme720.noimg", None, "altered"),
    ("gme720.noimg", None, "half"),
    ("gme240.img", None, "altered"),
    ("gme240.img", None, "half"),
    ("gme720.noimg", 4, "altered"),  # four data slots, as gme720x4's
    ("gme720.noimg", 4, "half"),
    ("gme720.noimg", 4, "exchange"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, data, fault):
    with _broken(monkeypatch, fault):
        rc, result, lines = run.run_cell(tiny_cell(workload, data=data), SEED, 0.5, False,
                                         device="cpu")
    assert rc == 0
    assert result["correct"] is False, lines
    assert result["failed"] > 0


@pytest.mark.parametrize("workload,data", [("gme240.img", None), ("gme720.noimg", 4)])
def test_sound_runs_are_correct(workload, data):
    rc, result, lines = run.run_cell(tiny_cell(workload, data=data), SEED + 7, 0.5, False,
                                     device="cpu")
    assert rc == 0 and result["correct"] is True, lines
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_a_wrong_png_is_caught(tmp_path):
    """One pixel of a written compensated frame changed: png_px_wrong 1."""
    from gme_tpu_torch.io.writers import write_png

    fr = clips.synthetic_pan(3, 96, 128, (2, 3), 9)
    gme = tiny_cell("gme240.img").config["gme"]
    ref = reference.clip(torch.from_numpy(fr), gme, 1, 8, {2})
    model, comp = ref["images"][2]
    out = tmp_path / "v"
    for s in ("frames", "compensated", "curr_prev_diff", "curr_comp_diff",
              "model_motion_field"):
        (out / s).mkdir(parents=True)
    bad = comp.copy()
    bad[5, 5] ^= 1
    write_png(str(out / "frames" / "-3.png"), fr[1])
    write_png(str(out / "compensated" / "-3.png"), bad)
    write_png(str(out / "curr_prev_diff" / "2.png"),
              np.abs(fr[2].astype(int) - fr[1]).astype(np.uint8))
    write_png(str(out / "curr_comp_diff" / "2.png"),
              np.abs(fr[2].astype(int) - comp).astype(np.uint8))
    write_png(str(out / "model_motion_field" / "2.png"), np.repeat(fr[1][..., None], 3, 2))
    px, needle = check.check_images(str(out), 2, 1, fr, model, comp, 16)
    assert px == 1
    assert needle > 0  # no arrow drawn where the model field has them
