"""The result line, the look for a card, the no-JAX check, BENCHMARK.json's
names, units and files, and the per-layer readers."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import nojax, run, spec
from benchmark.tests.tiny import SEED, tiny_cell
from benchmark.trace import DeviceEvent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", ["gme720.noimg", "gme240.img"])
def test_last_line_keys(workload):
    cell = tiny_cell(workload)
    rc, result, lines = run.run_cell(cell, SEED, 1.0, False, device="cpu")
    assert rc == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 8 == 0  # whole 8-pair clips
    # every end-to-end metric of the cell; those read from the device's
    # trace need a card
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end
                                      if m.source != "device_trace"}
    assert "setup_s" in result["metrics"]
    for m in result["metrics"].values():
        assert m["value"] > 0 and UNIT.match(m["unit"])
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"]
        assert any(line.startswith(f"{name} ") and "limit" in line for line in lines)
    json.dumps(result)


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
                        "gme720.noimg", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_nojax_compares_whole_top_level_names():
    assert nojax.loaded(["gme_tpu_torch", "gme_tpu_torch.ops.bbme", "jaxtyping", "numpy"]) == []
    assert nojax.loaded(["jax.numpy", "gme_tpu.ops", "flax.linen", "jaxlib"]) == [
        "flax", "gme_tpu", "jax", "jaxlib"]


def test_harness_process_loads_no_jax():
    """A run in a process of its own leaves no module of JAX behind."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark.tests.tiny import tiny_cell, SEED;"
            "from benchmark import run, nojax; run.run_cell(tiny_cell('gme720.noimg'), SEED, 0.5,"
            " False, device='cpu'); print(nojax.loaded())") % spec.ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "png.py", "clips.py"):
        tree = ast.parse(open(os.path.join(spec.HERE, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("gme_tpu", "gme_tpu_torch", "jax"), (name, m)


def test_benchmark_json_names_and_files():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert [w["name"] for w in bench["workloads"]] == ["gme720.noimg", "gme240.img"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    reports = {w["name"]: {m["name"] for m in bench["end_to_end"]
                           if w["name"] in m.get("workloads", [w["name"]])}
               for w in bench["workloads"]}
    for m in bench["per_layer"]:
        # each cell that reads it reports the end-to-end metric it moves
        assert all(m["moves"] in reports[w] for w in m["workloads"]), m["name"]
        assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
    for w, names in reports.items():
        assert "setup_s" in names and len(names) >= 2, w
        assert any(w in m["workloads"] for m in bench["per_layer"]), w
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.chips == cell.config["pipeline"]["mesh"]["data"]
        assert {m.name for m in cell.end_to_end} == reports[w["name"]]
    p90 = next(m for m in bench["per_layer"] if m["name"] == "driver.clip_s_p90")
    assert p90["workloads"] == ["gme720.noimg"]
    assert [m["name"] for m in bench["end_to_end"]] == ["setup_s", "pairs_per_s",
                                                        "kernel_ms_per_pair"]


def _ctx(events, pairs=206, cards=(0,), span=(0.0, 1e6), batch=24, data=1):
    summaries = [{"pairs_processed": 206, "stages": {
        "decode_wait": {"total_s": 0.0206, "count": 207},
        "dispatch": {"total_s": 0.18, "count": 9},
        "write_outputs": {"total_s": 2.06, "count": 9}}}] * 2
    config = {"frame": {"height": 720, "width": 1280},
              "pipeline": {"batch_size": batch, "mesh": {"data": data, "space": 1}},
              "gme": {"pyramid_levels": 3, "block_size": 16, "volume_radius": 32}}
    return {"config": config, "summaries": summaries,
            "traced": {"events": events, "ranges": [], "span_us": span, "pairs": pairs,
                       "cards": list(cards)}}


def test_stage_readers():
    ctx = _ctx([])
    read = spec.load_reader("driver.clip_s_p90")
    assert read(dict(ctx, clip_walls=[0.3] * 90 + [0.5] * 10)) == pytest.approx(0.3)
    assert read(dict(ctx, clip_walls=[0.3] * 80 + [0.5] * 20)) == pytest.approx(0.5)
    assert read(dict(ctx, clip_walls=[0.3] * 19)) is None
    assert spec.load_reader("decode.wait_ms_per_pair")(ctx) == pytest.approx(0.1)
    assert spec.load_reader("dispatch.ms_per_batch")(ctx) == pytest.approx(20.0)
    assert spec.load_reader("dispatch.ms_per_batch.720")(ctx) == pytest.approx(20.0)
    rate = spec.load_reader("driver.pairs_per_s")
    assert rate(dict(ctx, window={"pairs": 2060, "seconds": 2.5})) == pytest.approx(824.0)
    assert rate(dict(ctx, window={"pairs": 0, "seconds": 0.0})) is None
    assert spec.load_reader("writer.ms_per_pair")(ctx) == pytest.approx(10.0)


def test_device_readers():
    events = [DeviceEvent("k", 0, 0, 250e3), DeviceEvent("k", 0, 100e3, 300e3),
              DeviceEvent("k", 1, 0, 100e3)]
    ctx = _ctx(events, pairs=200, cards=(0, 1))
    assert spec.load_reader("device.busy_ms_per_pair")(ctx) == pytest.approx(400 / 200)
    assert spec.load_reader("device.idle_share")(ctx) == pytest.approx(1 - 400e3 / 2e6)
    assert spec.load_reader("device.busy_ms_per_pair")(_ctx([])) is None
    copies = events + [DeviceEvent("Memcpy HtoD (Pageable -> Device)", 0, 250e3, 900e3),
                       DeviceEvent("Memcpy DtoH (Device -> Pinned)", 0, 800e3, 1000e3)]
    read = spec.load_reader("device.copy_ms_per_pair")
    assert read(_ctx(copies, pairs=200, cards=(0, 1))) == pytest.approx(750 / 200)
    assert read(_ctx(events)) is None
    assert spec.load_reader("device.idle_share")(_ctx([])) is None


def test_roofline_reader():
    read = spec.load_reader("cost_volume_mse_block_roofline")
    # 206 pairs at B 24: 9 batches, 2 launches each; each launch 1 ms
    launches = [DeviceEvent("void cost_volume_mse_block_kernel<16>(...)", 0, i * 2e3,
                            i * 2e3 + 1e3) for i in range(18)]
    other = [DeviceEvent("chase_volume_kernel", 0, 0, 5e3)]
    share = read(_ctx(launches + other))
    assert share == pytest.approx(100 * 9 * (0.45004 + 0.11025) / 18, rel=1e-3)
    assert read(_ctx(launches[:-1])) is None  # not two a batch: nothing read
    assert read(_ctx(other)) is None
