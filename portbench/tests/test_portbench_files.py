"""A later change adds a cell, a traffic mix and a per-layer metric as files
and BENCHMARK.json entries alone: the harness finds each by its name."""

from __future__ import annotations

import json
import shutil
import time

from portbench import cells, run

READER = '''"""Scenes a pass, as the window served them."""


def read(run):
    return run.scenes_per_pass
'''


def test_new_cell_and_metric_from_files(tiny_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    pb = root / "portbench"
    t = json.loads((pb / "traffic" / "serve-b2.json").read_text())
    (pb / "traffic" / "serve-b1.json").write_text(json.dumps(dict(t, scenes_per_pass=1)))
    (pb / "workloads" / "tiny-new.json").write_text(json.dumps({"sample": {"scenes": 1}, "limits": {"rgb": 1e-3}}))
    (pb / "metrics" / "scenes_seen.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny-new", config="tiny", traffic="serve-b1", chips=1, why="added as files"))
    bench["per_layer"].append(dict(name="scenes_seen", unit="scenes", better="higher", source="host_clock",
                                   layer="sampler", moves="views_per_s", workloads=["tiny-new"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("tiny-new", root=root)
    assert [m["name"] for m in cell.per_layer][-1] == "scenes_seen"
    res = run.run(cell, 7, 0.5, True, "cpu", t0=time.perf_counter())
    line = run.result_line(cell, res, True, "cpu")
    assert line["correct"] and line["attempted"] == len(res["info"].passes)
    assert line["metrics"]["scenes_seen"] == {"value": 1.0, "unit": "scenes"}
    # the other cells do not report a metric whose workloads leave them out
    assert "scenes_seen" not in [m["name"] for m in cells.load("tiny-eval", root=root).per_layer]
