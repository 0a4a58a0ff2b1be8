"""A run with the timed path broken underneath has to come out not correct.

Each test skips the look for a card and drives a whole run of a tiny cell
on the program's plain kernels, with one fault planted in the program:
every other lane of each MSM left out, or an answer altered where it is made.
The clean runs are in test_bench_harness.py and below."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests import cells


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return cells.make_root(tmp_path_factory.mktemp("faults"))


def _half_lanes(monkeypatch):
    """MSMs over half of the lanes only: every other lane's scalar zeroed
    (every other, since the key's padding lanes fill the top of a tiny MSM)."""
    from go_snark_study_tpu_torch.ops import msm

    orig = msm.MSMEngine.window_sums_eager

    def half(self, points, limbs, c, plans=None):
        limbs = limbs.clone()
        limbs[:, 1::2] = 0
        return orig(self, points, limbs, c, None)

    monkeypatch.setattr(msm.MSMEngine, "window_sums_eager", half)


def _altered_total(monkeypatch):
    """Every MSM total moved by G where the host combination makes it."""
    from go_snark_study_tpu_torch.ops import msm

    orig = msm.combine_window_sums

    def altered(group, pts, c):
        return group.add(orig(group, pts, c), group.g)

    monkeypatch.setattr(msm, "combine_window_sums", altered)


def _altered_proof(monkeypatch):
    """Every proof's C moved by G1 where the prover assembles it."""
    from go_snark_study_tpu_torch.models import groth16_fast
    from go_snark_study_tpu_torch.models.groth16 import Proof

    orig = groth16_fast.FastGroth16.prove

    def altered(self, r1cs, pk, rng=None):
        p = orig(self, r1cs, pk, rng)
        g1 = self.ctx.bn.g1
        return Proof(pi_a=p.pi_a, pi_b=p.pi_b, pi_c=g1.add(p.pi_c, g1.g))

    monkeypatch.setattr(groth16_fast.FastGroth16, "prove", altered)


def _run(root, workload):
    line, _ = harness.run_cell(cells.load(root, workload), cells.SEED, 0.01, False, time.perf_counter(), device="cpu")
    return line


@pytest.mark.parametrize("workload,fault", [
    ("tiny-msm", _half_lanes), ("tiny-msm", _altered_total),
    ("tiny-bits", _half_lanes), ("tiny-bits", _altered_total),
    ("tiny-prove", _half_lanes), ("tiny-prove", _altered_proof),
])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    line = _run(tiny_root, workload)
    assert line["correct"] is False and line["checks"]["wrong_answers"]["value"] >= 1


def test_clean_prove_is_correct(tiny_root):
    line = _run(tiny_root, "tiny-prove")
    assert line["correct"] and line["checks"]["wrong_answers"] == {"value": 0, "limit": 0, "compared": 1}
