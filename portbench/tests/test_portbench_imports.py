"""The check on the run's modules compares top-level names whole."""

from __future__ import annotations

import sys
import time
import types

from portbench import cells, run


def test_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mvdfusion_tpu_torch_extra", types.ModuleType("mvdfusion_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert "mvdfusion_tpu" not in run.forbidden_modules() and "jax" not in run.forbidden_modules()
    for name in ("jax.numpy", "mvdfusion_tpu.nn", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"jax", "mvdfusion_tpu", "flax"} <= set(run.forbidden_modules())


def test_a_run_loads_no_jax(tiny_root):
    assert run.forbidden_modules() == []
    cell = cells.load("tiny-serve", root=tiny_root)
    run.run(cell, 11, 0.2, False, "cpu", t0=time.perf_counter())
    assert run.forbidden_modules() == []
    assert "mvdfusion_tpu_torch" in sys.modules
