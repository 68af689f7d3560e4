"""The harness end to end on the CPU at the tiny configuration (the kernels'
plain versions), through both entries: a well-formed last line, the
metrics each kind of run reports, the checks beside their limits."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import REPO

from portbench import cells, run


@pytest.mark.parametrize("cell,traced", [("tiny-eval", False), ("tiny-serve", True)])
def test_run_line(tiny_root, cell, traced):
    c = cells.load(cell, root=tiny_root)
    res = run.run(c, 2**31 + 12345, 1.0, traced, "cpu", t0=time.perf_counter())
    line = json.loads(json.dumps(run.result_line(c, res, traced, "cpu")))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 2 * len(res["info"].passes) >= 2
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    got = set(line["metrics"])
    assert got <= want
    if traced:
        # on the CPU the trace holds no device operation: the device readers find nothing
        assert {"prepare_ms", "decode_ms", "step_mfu"} <= got
        assert not got & {"gridattn_roofline", "unet_roofline", "device_idle_pct", "launches_per_step"}
        assert res["info"].trace["span_calls"]["step"] == c.config["inference"]["steps"]
        assert res["info"].trace["span_calls"]["gridattn"] == 2 * c.config["inference"]["steps"]
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert got == want
        assert len(res["info"].step_ms) == len(res["info"].passes) * c.config["inference"]["steps"]
    for k, v in line["check"].items():
        assert v["value"] <= v["limit"], k
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]


def test_main_needs_a_card(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no result;
    so it does in a directory that holds only BENCHMARK.json and portbench/."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cwd in (REPO, tmp_path):
        p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gso15-b2", "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode != 0
        assert "correct" not in p.stdout
