"""A cell of `BENCHMARK.json`, with its configuration, its traffic mix and
the readers of its per-layer metrics, each found by name in a file of its
own: `configs/<config>.json` (the entry's `file`), `traffic/<traffic>.json`
and `metrics/<metric>.py`.  Adding a cell, a mix or a metric adds files
and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    source: str = "host_clock"
    read: Optional[Callable] = None  # per-layer metrics: the reader


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, directory: str = os.path.join(HERE, "metrics")) -> Callable:
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = os.path.join(directory, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload` of `<root>/BENCHMARK.json`; raises
    KeyError for a name it does not hold."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(
        name=workload,
        chips=entry["chips"],
        config=config,
        traffic=traffic,
        end_to_end=[Metric(m["name"], m["unit"], m["source"]) for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[Metric(m["name"], m["unit"], m["source"], load_reader(m["name"]))
                   for m in bench["per_layer"] if _applies(m, workload)],
    )


def pipeline_settings(config: dict, traffic: dict) -> Dict:
    """The `PipelineConfig` fields a configuration states (its `gme`
    settings, mesh and batch) and the traffic's images on or off, as
    `PipelineConfig.from_dict` takes them."""
    p = config["pipeline"]
    return {
        "frame_distance": p["frame_distance"],
        "batch_size": p["batch_size"],
        "adaptive": p["adaptive"],
        "resume": p["resume"],
        "write_images": traffic["write_images"],
        "gme": dict(config["gme"]),
        "mesh": {"data": p["mesh"]["data"], "space": p["mesh"]["space"]},
    }
