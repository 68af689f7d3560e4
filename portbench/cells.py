"""Finds a cell's files by name.

BENCHMARK.json names the cell's configuration, traffic and metrics; the
files are portbench/configs/<config>.json (the path BENCHMARK.json gives),
portbench/traffic/<traffic>.json, portbench/workloads/<cell>.json (the
cell's correctness sample and limits), portbench/metrics/<metric>.py
(one reader a metric) and portbench/archs/<arch>.py (the architecture the
configuration's top-level "arch" names, "mvdfusion" where it names none).
A new cell, configuration, traffic mix, metric or architecture is new
files and new BENCHMARK.json entries; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = "portbench"
DEFAULT_ARCH = "mvdfusion"


class Cell(NamedTuple):
    name: str
    entry: dict  # the cell's entry of BENCHMARK.json's workloads
    config: dict
    traffic: dict
    spec: dict  # portbench/workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path
    arch: ModuleType  # portbench/archs/<arch>.py


def _named(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch_of(config: dict, root: Path = ROOT) -> ModuleType:
    """The module portbench/archs/<arch>.py under `root` for a
    configuration."""
    name = config.get("arch", DEFAULT_ARCH)
    return _load_file(Path(root) / HERE / "archs" / f"{name}.py", f"portbench_arch_{name}")


def load(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _named(bench["workloads"], name, "workload")
    cfg = _named(bench["configs"], w["config"], "config")
    read = lambda *parts: json.loads(root.joinpath(*parts).read_text())
    config = read(cfg["file"])
    return Cell(
        name=name, entry=w, config=config, traffic=read(HERE, "traffic", f"{w['traffic']}.json"),
        spec=read(HERE, "workloads", f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root, arch=arch_of(config, root),
    )


def reader(cell: Cell, metric: str):
    """The `read(run)` function of portbench/metrics/<metric>.py."""
    return _load_file(cell.root / HERE / "metrics" / f"{metric}.py", f"portbench_metric_{metric}").read
