"""The port's card hooks for the parity protocols (``models.accel``), run on
the CPU (``device="cpu"``: the kernels' plain versions) at ``min_size=4`` so
that every MSM and commitment batch of the cubic circuit takes them: the
flow verifies, and every key and proof point equals the hooks-off flow's as
a group element (the same seeded ``rng`` is consumed in the same order).
The same flows run on the card in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import random

import pytest
import torch

from go_snark_study_tpu_torch import api
from go_snark_study_tpu_torch.bn128 import default_bn128
from go_snark_study_tpu_torch.models import accel

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

CUBIC = """
func main(private s0, public s1):
	s2 = s0 * s0
	s3 = s2 * s0
	s4 = s3 + s0
	s5 = s4 + 5
	equals(s1, s5)
	out = 1 * 1
"""


def same_points(got, want) -> int:
    """Assert that two setups or proofs hold the same group elements, field
    by field (G2 points are the ones with Fq2 coordinates); returns how many
    points were compared."""
    bn = default_bn128()

    def eq(a, b):
        if isinstance(a, tuple) and len(a) == 3:
            g = bn.g2 if isinstance(a[0], tuple) else bn.g1
            assert g.equal(a, b)
            return 1
        if isinstance(a, list) and a and isinstance(a[0], tuple):
            assert len(a) == len(b)
            return sum(eq(x, y) for x, y in zip(a, b))
        if dataclasses.is_dataclass(a):
            return sum(eq(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
        assert a == b
        return 0

    return eq(got, want)


@pytest.fixture(scope="module")
def cpu_engines():
    """The CPU engines, built once (the fixed-base tables take a second)."""
    return accel.msm_engines("cpu"), accel.fixed_base_engines("cpu")


@pytest.fixture(scope="module")
def bundle():
    return api.compile_circuit(source=CUBIC, private_inputs=[3], public_inputs=[35])


def hooked_and_host(flow, bundle, seed, device):
    accel.enable_gpu_msm(device=device, min_size=4)
    accel.enable_gpu_setup(device=device, min_size=4)
    try:
        hooked = flow(bundle, rng=random.Random(seed))
    finally:
        accel.disable_gpu_msm()
        accel.disable_gpu_setup()
    return hooked, flow(bundle, rng=random.Random(seed))


def check_flow(flow, bundle, seed, device):
    (setup, proof, ok), (hsetup, hproof, hok) = hooked_and_host(flow, bundle, seed, device)
    assert ok and hok
    assert same_points(setup, hsetup) > 20
    assert same_points(proof, hproof) >= 3


def test_accelerated_groth16_flow(cpu_engines, bundle):
    check_flow(api.groth16_flow, bundle, 9, "cpu")


@pytest.mark.slow
def test_accelerated_pinocchio_flow(cpu_engines, bundle):
    check_flow(api.pinocchio_flow, bundle, 8, "cpu")


def test_hooks_decline_only_below_min_size(cpu_engines, monkeypatch):
    """Below ``min_size`` a hook returns None and the host loop runs; at
    ``min_size`` the engine runs, and an engine failure is raised, not
    swallowed."""
    from go_snark_study_tpu_torch.models.context import default_context

    ctx = default_context()
    g1 = ctx.bn.g1
    pts = [g1.mul_scalar(g1.g, k) for k in (2, 3, 5)]
    accel.enable_gpu_msm(device="cpu", min_size=4)
    try:
        calls = []
        monkeypatch.setattr(cpu_engines[0][0], "msm", lambda p, s: calls.append(len(p)) or g1.zero())
        assert g1.equal(ctx.msm_g1(pts, [1, 1, 1]), g1.mul_scalar(g1.g, 10))
        assert calls == []
        assert ctx.msm_g1(pts + [g1.g], [1, 1, 1, 1]) == g1.zero()
        assert calls == [4]

        def fail(p, s):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(cpu_engines[0][0], "msm", fail)
        with pytest.raises(RuntimeError, match="launch failed"):
            ctx.msm_g1(pts + [g1.g], [1, 1, 1, 1])
    finally:
        accel.disable_gpu_msm()


def test_enable_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accel.enable_gpu_msm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accel.enable_gpu_setup()
