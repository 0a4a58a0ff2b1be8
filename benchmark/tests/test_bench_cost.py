"""The frozen cost model against hand-worked counts at 2^16 and 2^20."""

from __future__ import annotations

import pytest
import torch

from benchmark import cost

CLOCK = 1.98e9  # the H100 SXM's maximum SM clock
IMAD_RATE = 132 * 64 * CLOCK


def test_uniform_adds_at_2e16_and_2e20():
    # 2^16: c = 12 gives 22 windows x (65,536 + 8,192); c = 11 24 x 69,632, c = 13 20 x 81,920
    assert cost.bucket_adds_uniform(1 << 16) == 22 * (65536 + 8192) == 1_622_016
    # 2^20: c = 16 gives 16 x (1,048,576 + 131,072); c = 15 gives 17 x 1,114,112
    assert cost.bucket_adds_uniform(1 << 20) == 16 * (1048576 + 131072) == 18_874_368


def test_msm_work_and_least_time_at_2e20():
    w = cost.msm_work(1 << 20, 1, cost.bucket_adds_uniform(1 << 20))
    assert w["int32_ops"] == 18_874_368 * 11 * 264 == 54_811_164_672
    assert w["bytes"] == (1 << 20) * 96 + 96
    t = cost.least_seconds([w], CLOCK)
    assert t["bound"] == "operations" and t["seconds"] == pytest.approx(54_811_164_672 / IMAD_RATE)
    assert t["seconds"] == pytest.approx(3.2768e-3, rel=1e-4)
    g2 = cost.msm_work(1 << 16, 2, cost.bucket_adds_uniform(1 << 16))
    assert g2["int32_ops"] == 1_622_016 * 29 * 264 and g2["bytes"] == (1 << 16) * 160 + 192


def test_exact_adds_of_small_scalars():
    limbs = torch.zeros((8, 4), dtype=torch.int32)
    limbs[0] = torch.tensor([1, 2, 0, 3])
    assert cost.bucket_adds_exact(limbs) == 3 + 2 * 16  # one window of width 4: 3 digits, 16 buckets
    limbs[7, 0] = 1 << 20  # bit 244: a second non-empty window at any width
    # best is c = 4: windows 0 (3 digits) and 61 (bits 244-247: 1 digit), 2 x 32 bucket adds
    assert cost.bucket_adds_exact(limbs) == 3 + 1 + 2 * 2 * 16


def test_exact_adds_of_uniform_scalars_match_the_formula():
    g = torch.Generator().manual_seed(3)
    n = 1 << 16
    limbs = torch.randint(0, 1 << 32, (8, n), generator=g, dtype=torch.int64)
    limbs[7] %= cost_r_top()
    exact = cost.bucket_adds_exact(limbs.to(torch.int32))
    # below the formula by the zero digits and the top window's few digits (r < 2^254)
    assert 0.97 * cost.bucket_adds_uniform(n) < exact <= cost.bucket_adds_uniform(n)


def cost_r_top():
    from benchmark.reference import R

    return R >> 224
