"""K1's launch plan (ops/groupnorm.py::plan_group_norm) on the CPU: for every
GroupNorm shape the UNet and the VAE launch through K1, at CFG batches 1, 2,
16, 30, 32 and 60 (32 and 60: two scenes a sampler pass on the flagship and
the evaluation paths) and at ragged row counts, the plan's CTAs cover each row of a
sample exactly once, fit the card's shared memory and thread limits, and
form a cluster the kernel takes (1..16 CTAs, a power of two). No card is
needed: the plan is host arithmetic."""

import pytest
import torch

from mvdfusion_tpu_torch.ops import groupnorm as K1

# (N, C) of every K1 call of a UNet step (nn/unet.py: 32^2, 16^2, 8^2 and
# 4^2 maps; ResBlock inputs with skip channels, site norms) and the VAE's
# 32^2 maps
UNET_SHAPES = [(1024, 320), (1024, 640), (1024, 960), (256, 320), (256, 640), (256, 960), (256, 1280),
               (256, 1920), (64, 640), (64, 1280), (64, 1920), (64, 2560), (16, 1280), (16, 2560)]
VAE_SHAPES = [(1024, 512), (1024, 256)]
RAGGED_SHAPES = [(1000, 320), (77, 640), (15, 1280), (1, 2560), (3000, 96)]


def _rows_of_cta(plan, N, rank):
    """The rows CTA `rank` reads, lane by lane, as the kernel walks them."""
    r0, r1 = rank * plan.rows, min(N, (rank + 1) * plan.rows)
    return [r for p in range(plan.P) for r in range(r0 + p, r1, plan.P)]


def _smem(plan, C, vec):
    return (2 * C + 4 * 32) * 4 + (plan.rows * K1.gn_stride(C // vec, plan.P) * 16 if plan.resident else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("B", [1, 2, 16, 30, 32, 60])
def test_k1_plan_covers_rows_and_fits_the_card(B, dtype):
    for N, C in UNET_SHAPES + VAE_SHAPES + RAGGED_SHAPES:
        plan = K1.plan_group_norm(B, N, C, dtype)
        vec = 8 if dtype == torch.bfloat16 else 4
        assert plan.k in (1, 2, 4, 8, 16) and plan.k <= K1.GN_MAX_CLUSTER, (N, C, plan)
        rows = sorted(r for rank in range(plan.k) for r in _rows_of_cta(plan, N, rank))
        assert rows == list(range(N)), f"{(N, C)}: rows not covered exactly once by {plan}"
        assert plan.threads % 32 == 0 and (C // vec) * plan.P <= plan.threads <= K1.GN_MAX_THREADS, (N, C, plan)
        assert plan.P & (plan.P - 1) == 0 and plan.P <= K1.GN_MAX_LANES, (N, C, plan)
        assert plan.smem <= K1.GN_SMEM_MAX and plan.smem == _smem(plan, C, vec), (N, C, plan)
        if dtype == torch.bfloat16 and N * C <= 1 << 20:
            # every slice K1's gate passes stays on chip: one read of x
            assert plan.resident, (N, C, plan)


# clusters the H100 holds at once by cluster size at the flagship's 32^2
# maps (chip_smoke.py --k1-sweep, bf16, 160-thread CTAs)
HELD = {4: 124, 8: 30, 16: 28}


def test_k1_plan_weighs_waves_against_cta_bytes():
    """The plan's cost model picks, from the card's count of clusters held
    at once, what the sweep measured fastest: 16 CTAs a sample at the
    flagship's (16, 1024, 320) (one wave of 41 KB CTAs), 8 at the eval's
    (30, 1024, 320) (one wave against two), and 16 at (16, 1024, 960),
    where only 16 CTAs keep a sample's rows."""
    held = lambda plan: HELD[plan.k]
    assert K1.plan_group_norm(16, 1024, 320, torch.bfloat16, held=held).k == 16
    assert K1.plan_group_norm(30, 1024, 320, torch.bfloat16, held=held).k == 8
    assert K1.plan_group_norm(16, 1024, 960, torch.bfloat16, held=lambda plan: 7).k == 16
    for N, C in UNET_SHAPES:
        assert K1.plan_group_norm(16, N, C, torch.bfloat16).k in K1.GN_CLUSTERS


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_k1_plan_takes_a_forced_cluster_size(k):
    """A forced k (the chip's sweep of cluster sizes) keeps the row cover and
    falls back to a second read where the rows no longer fit."""
    plan = K1.plan_group_norm(30, 1024, 960, torch.bfloat16, k=k)
    assert plan.k == k and plan.rows * k >= 1024
    rows = sorted(r for rank in range(k) for r in _rows_of_cta(plan, 1024, rank))
    assert rows == list(range(1024))
    assert plan.resident == (_smem(plan._replace(resident=True), 960, 8) <= K1.GN_SMEM_MAX)


def test_k1_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        K1.plan_group_norm(2, 64, 100, torch.bfloat16)  # not whole 16-byte vectors
    with pytest.raises(ValueError):
        K1.plan_group_norm(2, 64, 8 * K1.GN_MAX_THREADS + 64, torch.bfloat16)  # more channel vectors than threads
    with pytest.raises(ValueError):
        K1.plan_group_norm(2, 64, 320, torch.bfloat16, k=32)
    with pytest.raises(TypeError):
        K1.plan_group_norm(2, 64, 320, torch.float16)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_k1_row_stride_spreads_a_quarter_warp_over_the_banks(P):
    """The padded row stride puts the 8 threads of a quarter warp (P row
    lanes of 8 / P channel vectors each, or 8 rows of one vector) on 8
    distinct 16-byte bank groups, for every channel count of the UNet."""
    for cv in (12, 24, 40, 64, 80, 120, 160, 240, 320, 640):
        ld = K1.gn_stride(cv, P)
        assert cv <= ld < cv + 8
        for first in range(0, 32, 8):  # the four quarter warps
            lanes = range(first, first + 8)
            groups = {((t % P) * ld + t // P) % 8 for t in lanes}
            assert len(groups) == 8, (cv, P, ld)
