"""The readers of the program's own spans (portbench/program_spans.py) on a
CPU run of a tiny cell: each reads the window's passes and only those, and
each gives None where the program never loaded its tracing module."""

from __future__ import annotations

import importlib
import statistics
import sys
import time

import pytest
import torch

from portbench import cells, program_spans, run

READERS = ("host_step_ms", "device_step_ms", "own_launches_per_step", "host_unet_ms", "host_gridattn_ms")


@pytest.fixture(scope="module")
def traced_run(tiny_root):
    """A traced CPU run of tiny-serve on a ring emptied first; the ring's
    pass records (the warm-up, the window's, the profiled pass)."""
    cell = cells.load("tiny-serve", root=tiny_root)
    importlib.import_module(program_spans.MODULE).clear()
    res = run.run(cell, 2**31 + 777, 1.0, True, "cpu", t0=time.perf_counter())
    passes = [r for r in sys.modules[program_spans.MODULE].records() if r.name == "sample.pass"]
    return cell, res, passes


def test_readers_read_the_window(traced_run):
    cell, res, passes = traced_run
    info = res["info"]
    steps = cell.config["inference"]["steps"]
    n = len(info.passes)
    assert len(passes) == n + 2 and not passes[0].profiled and passes[-1].profiled
    window = program_spans.window_steps(info)
    assert [s.pass_id for s, _ in window] == [p.pass_id for p in passes[1:-1] for _ in range(steps)]
    for s, inside in window:
        assert s.name == "sample.step" and sorted(r.name for r in inside) == \
            ["model.gridattn"] * info.scenes_per_pass + ["model.unet"]
    got = {m: cells.reader(cell, m)(info) for m in READERS}
    assert got["device_step_ms"] is None  # no CUDA events on the CPU
    assert got["own_launches_per_step"] == 0.0  # the CPU takes the plain versions
    assert got["host_step_ms"] == statistics.median(s.host_ms for s, _ in window)
    assert 0 < got["host_unet_ms"] < got["host_step_ms"] and 0 < got["host_gridattn_ms"] < got["host_step_ms"]
    line = run.result_line(cell, res, True, "cpu")
    assert {m for m in READERS if got[m] is not None} <= set(line["metrics"])


def test_readers_without_the_module(traced_run, monkeypatch):
    """A program that never loaded the tracing module (the parent's) gives
    None, and the traced line leaves the metrics out."""
    cell, res, _ = traced_run
    monkeypatch.delitem(sys.modules, program_spans.MODULE)
    assert all(cells.reader(cell, m)(res["info"]) is None for m in READERS)
    assert not set(READERS) & set(run.metrics(cell, res["info"], True))


def test_readers_when_the_ring_lacks_the_window(traced_run, monkeypatch):
    cell, res, passes = traced_run
    mod = sys.modules[program_spans.MODULE]
    monkeypatch.setattr(mod, "records", lambda: [r for r in passes[-2:]])
    assert all(cells.reader(cell, m)(res["info"]) is None for m in READERS)


@pytest.mark.gpu
def test_device_step_ms_against_the_step_events(tiny_root):
    """On the card device_step_ms reads within 2% of the median of the
    benchmark's own step events (run.step_ms) in the same run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.load("tiny-serve", root=tiny_root)
    res = run.run(cell, 2**31 + 778, 3.0, False, "cuda", t0=time.perf_counter())
    info = res["info"]
    ours, theirs = cells.reader(cell, "device_step_ms")(info), statistics.median(info.step_ms)
    assert abs(ours / theirs - 1) < 0.02, (ours, theirs)
    assert cells.reader(cell, "own_launches_per_step")(info) > 0
