"""The port's bench (``go_snark_study_tpu_torch/bench.py``) held to the
repository's ``bench.py`` on the CPU, at 64 points: the line's shape and
names, the random draws that make the MSMs' inputs, the warmup calls, the
exit code of a failed stage or a wrong result, and no run without a card.

No JAX engine runs here.  ``FastGroth16.warmup`` is recorded, not run: on
the CPU it would run the tiled MSM pieces at 8,192 lanes through the plain
kernels (about two minutes); its arguments are held to bench.py's.  The
tests of ``main`` replace the stages with cheap stand-ins, since ``main``
takes bench.py's sizes from the environment and runs Montgomery products at
2^20 lanes; the planted faults run ``main`` through the real stages, their
own checks included, with the costly engine calls replayed or stood in for.
The card runs the real bench in ``tests/test_torch_gpu.py`` and in
``chip_smoke.py``'s ``bench`` phase.
"""

import json
import os
import random
from types import SimpleNamespace

import pytest
import torch

from go_snark_study_tpu_torch import bench
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
from go_snark_study_tpu_torch.ops.curve_ops import tree_leaves
from go_snark_study_tpu_torch.ops.msm import MSMEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64  # the MSMs' and the NTT's points; Montgomery products at 1,024 lanes
SEED = 0xBEEF  # bench.py:225
SERIAL_DRAWS = 8  # bench.py:240-244

# bench.py's line (bench.py:101-131) and its sub keys for the stages that
# run with tiers=() and msm21=False, as the port names them at 2^6 points,
# each beside bench.py's own spelling of it.
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "sub"}  # bench.py:103-108
SUB_KEYS = {
    "warmup_s": 'RESULT["sub"]["warmup_s"]',  # bench.py:299
    "compile_warmup_s": 'RESULT["sub"]["compile_warmup_s"]',  # :348
    "msm_2^6_ms": 'RESULT["sub"][f"msm_2^{plog}_ms"]',  # :406
    "msm_compile_s": 'RESULT["sub"]["msm_compile_s"]',  # :407
    "msm_points_mode": 'RESULT["sub"]["msm_points_mode"]',  # :408
    "msm_fallback_hits": 'RESULT["sub"]["msm_fallback_hits"]',  # :409
    "mfu": 'RESULT["sub"].setdefault("mfu", {})',  # :410, :441, :471
    "ntt_compile_s": 'RESULT["sub"]["ntt_compile_s"]',  # :432
    "ntt_2^6_ms": 'RESULT["sub"][f"ntt_2^{nlog}_ms"]',  # :440
    "modmul_mps": 'RESULT["sub"]["modmul_mps"]',  # :470
    "compile_warmup_rest_s": 'RESULT["sub"]["compile_warmup_rest_s"]',  # :502
    "compile_warmup_rest_done": 'RESULT["sub"]["compile_warmup_rest_done"]',  # :503
}
MFU_KEYS = {"msm_accumulate", "ntt_butterfly", "modmul"}  # bench.py:410, :441, :471
# the port's own: the card beside every number, its model, the run's launches
PORT_SUB_KEYS = {"card", "chip_model", "launches"}
# bench.py's two warmup calls (bench.py:345, :486-491), tiers=()
WARMUPS = [dict(families=("big",), domains=(), g2=False, fixed_base=True),
           dict(families=("big", "small"), domains=[], g2=True, fixed_base=True)]


@pytest.fixture(scope="module")
def cpu_run():
    """One run at 64 points on the CPU: its line, the warmup calls, the MSM
    inputs and the window sums of each MSM run (its points, limbs, c and
    sums)."""
    warmups, msm_inputs, window_sums = [], [], []
    msm_run, sums_checked = bench._msm_run, MSMEngine.window_sums_checked

    def spy(fast, scalars, ks, runs):
        msm_inputs.append((list(scalars), ks and list(ks), runs))
        return msm_run(fast, scalars, ks, runs)

    def sums_spy(self, aff, limbs, c, plans=None):
        sums = sums_checked(self, aff, limbs, c, plans)
        window_sums.append((aff, limbs, c, sums))
        return sums

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FastGroth16, "warmup", lambda self, **kw: warmups.append(kw) or {})
        mp.setattr(bench, "_msm_run", spy)
        mp.setattr(MSMEngine, "window_sums_checked", sums_spy)
        line = bench.run(device="cpu", msm_points=N, ntt_points=N, modmul_lanes=1024, tiers=(), msm21=False)
    return SimpleNamespace(line=line, warmups=warmups, msm_inputs=msm_inputs, window_sums=window_sums)


def test_line_has_bench_py_shape(cpu_run):
    line = cpu_run.line
    src = open(os.path.join(REPO, "bench.py")).read()
    for spelling in SUB_KEYS.values():
        assert spelling in src, spelling
    assert set(line) == LINE_KEYS | {"correct"}
    assert line["metric"] == "msm_g1_points_per_sec_2^6" and line["unit"] == "points/s"
    assert line["correct"] is True
    sub = line["sub"]
    assert set(sub) == set(SUB_KEYS) | PORT_SUB_KEYS, set(sub) ^ (set(SUB_KEYS) | PORT_SUB_KEYS)
    assert set(sub["mfu"]) == MFU_KEYS and all(v > 0 for v in sub["mfu"].values())
    assert set(sub["warmup_s"]) == {"device_init", "first_roundtrip", "kernel_build"}
    assert sub["warmup_s"]["kernel_build"] == {}  # the CPU builds nothing
    assert (sub["card"], sub["chip_model"], sub["msm_points_mode"]) == ("cpu", "host CPU", "distinct")
    assert line["value"] == pytest.approx(N / (sub["msm_2^6_ms"] / 1e3))
    assert line["vs_baseline"] > 0
    json.dumps(line)


def test_msm_equals_host_oracle(cpu_run):
    """Both timed runs of the 2^6 MSM equal (Σ s_i·k_i)·G (bench.py:385-391)."""
    line = cpu_run.line
    (scalars, ks, runs), = cpu_run.msm_inputs
    assert runs == 2 and len(scalars) == len(ks) == N
    assert line["correct"] is True and line["metric"].startswith("msm_g1")


def test_warmups_are_bench_py_calls(cpu_run):
    assert cpu_run.warmups == WARMUPS


def test_msm_inputs_are_bench_py_draws(cpu_run):
    """After the serial baseline's 8 draws, the scalars, then the
    multipliers (bench.py:240-244, :356, :372)."""
    rng = random.Random(SEED)
    for _ in range(SERIAL_DRAWS):
        rng.randrange(C.R)
    scalars = [rng.randrange(C.R) for _ in range(N)]
    ks = [rng.randrange(1, C.R) for _ in range(N)]
    assert cpu_run.msm_inputs[0][:2] == (scalars, ks)


def test_msm21_draws_multipliers_first(monkeypatch):
    """The 2^21 stage draws its multipliers before its scalars
    (bench.py:591-595); one run."""
    seen = []
    monkeypatch.setattr(bench, "_msm_run", lambda fast, s, k, runs: seen.append((s, k, runs)) or dict(
        runs_s=[0.5], correct=True))
    out = bench.msm21_stage(FastGroth16(device="cpu"), random.Random(SEED), n_points=N)
    rng = random.Random(SEED)
    ks = [rng.randrange(1, C.R) for _ in range(N)]
    scalars = [rng.randrange(C.R) for _ in range(N)]
    assert seen == [(scalars, ks, 1)]
    assert out["sub"] == {"msm_2^6_ms": 500.0, "msm_2^6_pts_per_s": N / 0.5}  # bench.py:602-603


def _stand_ins(monkeypatch, calls, fail=None):
    """Cheap stages that record their calls; ``fail`` names one that raises
    or returns a wrong result."""

    def stage(name, out):
        def fn(*a, **k):
            calls.append(name)
            if fail == (name, "raise"):
                raise RuntimeError(f"{name} failed")
            return dict(out, correct=fail != (name, "wrong"))
        return fn

    sub_mfu = lambda k: {"mfu": {k: 0.5}}
    monkeypatch.setattr(FastGroth16, "warmup", lambda self, **kw: {})
    monkeypatch.setattr(bench, "serial_baseline", stage("serial_baseline", {"serial_pts_per_s": 100.0, "sub": {}}))
    monkeypatch.setattr(bench, "device_warmup", stage("device_warmup", {"sub": {"warmup_s": {}}}))
    monkeypatch.setattr(bench, "msm_stage", stage("msm", {"msm_pts_per_s": 1e6, "msm_log2": 6,
                                                          "sub": {"msm_2^6_ms": 0.064, **sub_mfu("msm_accumulate")}}))
    monkeypatch.setattr(bench, "ntt_stage", stage("ntt", {"sub": {"ntt_2^6_ms": 0.01, **sub_mfu("ntt_butterfly")}}))
    monkeypatch.setattr(bench, "modmul_stage", stage("modmul", {"sub": {"modmul_mps": 1.0, **sub_mfu("modmul")}}))
    monkeypatch.setattr(bench, "tier_stage", stage("prove", {"sub": {"groth16_prove_2^5_s": 1.0}}))
    monkeypatch.setattr(bench, "msm21_stage", stage("msm_2^21", {"sub": {}}))
    for k, v in (("GOSNARK_BENCH_MSM", "64"), ("GOSNARK_BENCH_NTT", "64"), ("GOSNARK_BENCH_PROVE", "5"),
                 ("GOSNARK_BENCH_MSM21", "0")):
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("fail, rc, error", [
    (None, 0, None),
    (("ntt", "raise"), 1, "error_ntt"),
    (("msm", "wrong"), 1, None),
    (("prove", "wrong"), 1, None),
    (("device_warmup", "raise"), 1, "error_device_warmup"),
], ids=["all-pass", "stage-raises", "msm-wrong", "verify-fails", "build-fails"])
def test_main_exit_code(monkeypatch, capsys, fail, rc, error):
    """A stage that raises, a wrong MSM or a proof that does not verify
    makes ``main`` return 1 after the line; a device warmup that fails (the
    kernels' build included) stops the run there, with no fallback."""
    calls = []
    _stand_ins(monkeypatch, calls, fail)
    assert bench.main([], device="cpu") == rc
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is (fail is None or fail[1] == "raise")
    if error:
        assert error in line["sub"]
    if fail == ("device_warmup", "raise"):
        assert calls == ["serial_baseline", "device_warmup"]
    else:
        assert calls == ["serial_baseline", "device_warmup", "msm", "ntt", "modmul", "prove"]
    if rc == 0:
        assert line["metric"] == "msm_g1_points_per_sec_2^6" and line["vs_baseline"] == 1e4
    elif fail[1] == "wrong":
        assert line["metric"] == "msm_g1_points_per_sec" and line["value"] == 0 and "error" in line


@pytest.mark.parametrize("fault", [None, "msm-oracle", "verify"], ids=["none", "msm-oracle", "verify"])
def test_main_planted_fault(cpu_run, monkeypatch, capsys, fault):
    """A wrong MSM total (the real msm stage's comparison with (Σ s_i·k_i)·G)
    or a proof that does not verify (the real tier stage's verify_proof)
    makes ``main`` return 1 with ``correct`` false and no error; with no
    fault the same run returns 0.  Only bench.py's size variables are set.
    To stay cheap on the CPU: the MSM's window sums are the fixture's,
    replayed for the same inputs (the plain kernels take ~3 s a run here);
    Montgomery products run at 1,024 lanes rather than main's 2^20; the
    tier's setup and proves are stand-ins (a setup and two proves take ~45 s
    here even at 4 constraints)."""
    aff0, limbs0, c0, sums0 = cpu_run.window_sums[0]

    def replay(self, aff, limbs, c, plans=None):
        assert c == c0 and torch.equal(limbs, limbs0)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(aff), tree_leaves(aff0), strict=True))
        return sums0

    monkeypatch.setattr(MSMEngine, "window_sums_checked", replay)
    monkeypatch.setattr(FastGroth16, "warmup", lambda self, **kw: {})
    modmul = bench.modmul_stage
    monkeypatch.setattr(bench, "modmul_stage", lambda Kr, lanes: modmul(Kr, 1024))
    dpk = SimpleNamespace(**{f: torch.zeros(1, dtype=torch.int32) for f in ("at", "b1", "b2", "cdelta", "ptau")})
    setup = SimpleNamespace(pk=SimpleNamespace(_device=dpk), vk="vk")
    monkeypatch.setattr(FastGroth16, "setup", lambda self, r1cs, rng, materialize_host: setup)
    monkeypatch.setattr(FastGroth16, "prove", lambda self, r1cs, pk, rng: ("proof", rng.random()))
    verified = []
    monkeypatch.setattr(bench, "verify_proof",
                        lambda vk, proof, publics: verified.append((vk, proof[0])) or fault != "verify")
    if fault == "msm-oracle":
        combine = bench.combine_window_sums
        monkeypatch.setattr(bench, "combine_window_sums", lambda g, sums, c: g.add(combine(g, sums, c), g.g))
    for k, v in (("GOSNARK_BENCH_MSM", str(N)), ("GOSNARK_BENCH_NTT", str(N)), ("GOSNARK_BENCH_PROVE", "2"),
                 ("GOSNARK_BENCH_MSM21", "0")):
        monkeypatch.setenv(k, v)
    assert bench.main([], device="cpu") == (0 if fault is None else 1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not [k for k in line["sub"] if k.startswith(("error_", "skipped_"))], line["sub"]
    assert line["correct"] is (fault is None)
    assert verified == [("vk", "proof")] and "groth16_prove_2^2_s" in line["sub"]
    if fault is None:
        assert line["metric"] == "msm_g1_points_per_sec_2^6"
    else:
        assert line["metric"] == "msm_g1_points_per_sec" and line["value"] == 0


def test_main_without_card_runs_nothing(monkeypatch, capsys):
    """``main(device=None)`` with no card prints the error line and returns
    1 before any stage, the host's serial baseline included."""
    calls = []
    _stand_ins(monkeypatch, calls)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert calls == []
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0 and "error_device" in line["sub"] and line["correct"] is False
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
