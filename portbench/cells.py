"""Finds a cell's files by name.

BENCHMARK.json names the cell's configuration, traffic and metrics; the
files are portbench/configs/<config>.json (the path BENCHMARK.json gives),
portbench/traffic/<traffic>.json, portbench/workloads/<cell>.json (the
cell's correctness sample and limits) and portbench/metrics/<metric>.py
(one reader a metric). A new cell, configuration, traffic mix or metric is
new files and new BENCHMARK.json entries; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = "portbench"


class Cell(NamedTuple):
    name: str
    entry: dict  # the cell's entry of BENCHMARK.json's workloads
    config: dict
    traffic: dict
    spec: dict  # portbench/workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path


def _named(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _named(bench["workloads"], name, "workload")
    cfg = _named(bench["configs"], w["config"], "config")
    read = lambda *parts: json.loads(root.joinpath(*parts).read_text())
    return Cell(
        name=name, entry=w, config=read(cfg["file"]), traffic=read(HERE, "traffic", f"{w['traffic']}.json"),
        spec=read(HERE, "workloads", f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def reader(cell: Cell, metric: str):
    """The `read(run)` function of portbench/metrics/<metric>.py."""
    path = cell.root / HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
