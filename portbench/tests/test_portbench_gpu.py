"""Card-only tests (marker `gpu`; each decides inside itself whether a card
is there). Run on the card with

    python -m pytest portbench/tests -q -p no:cacheprovider -m gpu
"""

from __future__ import annotations

import pytest
import torch

from conftest import TINY_LIMITS

from portbench import cells, control, yardstick


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_control_on_the_card(tiny_root):
    """The control at the tiny size on the card reads each number ten times
    the program's worst or more. (The program's card route reads 4e-4 to
    4e-3 here, above the CPU's tiny limits, which hold its plain route.)"""
    _card()
    c = cells.load("tiny-eval", root=tiny_root)
    res = control.readings(c, [21, 22], [21], "cuda", log=lambda *a, **k: None)
    worst = {k: max(r[k] for r in res["program"].values()) for k in TINY_LIMITS}
    for nums in res["control"].values():
        assert all(v > 10 * worst[k] for k, v in nums.items()), (nums, worst)


@pytest.mark.gpu
def test_peak_bounds_a_large_gemm():
    """A bf16 product at a size cuBLAS runs near its best stays under the
    table's peak, so a share of it cannot pass 100% for want of a peak."""
    _card()
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        a @ a
    end.record()
    torch.cuda.synchronize()
    share = 20 * 2 * 8192**3 / (start.elapsed_time(end) * 1e-3) / yardstick.PEAK_BF16_FLOPS
    assert 0.3 < share <= 1.0, share
