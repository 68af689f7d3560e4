"""The plain reference against the port at the tiny configuration on the
CPU, the control (the reference in float8) against the reference, and the
reference's independence from the program."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import REPO, TINY_LIMITS

from portbench import cells, control


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-serve"])
def test_reference_matches_port_and_control_fails(tiny_root, cell):
    """The port in float32 on its plain route sits within float32 rounding of
    the reference through prepare, every step and the decode; the control
    misses every limit by orders of magnitude."""
    c = cells.load(cell, root=tiny_root)
    res = control.readings(c, [3, 4], [3], "cpu", log=lambda *a, **k: None)
    for seed, nums in res["program"].items():
        assert set(nums) == ({"rgb", "depth", "vae"} if c.traffic["decodes_ground_truth"] else {"rgb", "depth"})
        for k, v in nums.items():
            assert v < 1e-4, (seed, k, v)
    for seed, nums in res["control"].items():
        assert all(v > 10 * TINY_LIMITS[k] for k, v in nums.items()), (seed, nums)


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from portbench import reference, check, weights, traffic, counts\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'mvdfusion_tpu',"
        " 'mvdfusion_tpu_torch'})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
    for name in ("reference.py", "check.py", "weights.py", "traffic.py", "counts.py"):
        text = (REPO / "portbench" / name).read_text()
        assert "import mvdfusion" not in text and "from mvdfusion" not in text, name


def test_fake_quantize_rounds_to_float8():
    from portbench import reference

    lin = torch.nn.Linear(64, 8)
    w = lin.weight.detach().clone()
    reference.fake_quantize_(lin)
    s = 448.0 / w.abs().max()
    assert torch.equal(lin.weight, (w * s).to(torch.float8_e4m3fn).float() / s)
    x = torch.randn(3, 64)
    xs = 448.0 / x.abs().max()
    want = torch.nn.functional.linear((x * xs).to(torch.float8_e4m3fn).float() / xs, lin.weight, lin.bias)
    assert torch.allclose(lin(x), want)
