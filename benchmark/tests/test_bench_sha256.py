"""The SHA-256 cell on the CPU: a tiny root with a two-round, one-block copy
of ``sha256-2e20`` (a 3-byte message, 1,023 rows) run through the harness
on the program's plain kernels; a planted fault turns it not correct; the
re-run reader; and a reference that imports nothing of the program.

    python -m pytest -q benchmark/tests/test_bench_sha256.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness, reference, reference_sha256, spec
from benchmark.tests import cells
from benchmark.tests.test_bench_harness import _imports

CELL, CONFIG, LIKE = "tiny-sha256", "tiny-sha256", "prove-sha256-2e20"
# what a run on the CPU can read of the cell's metrics (no device trace)
ON_CPU = ("prove_s", "setup_s", "trusted_setup_s", "bridge_ms.prove", "assembly_ms.prove", "gc_pause_ms.prove",
          "rerun_ms.prove")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = cells.make_root(tmp_path_factory.mktemp("sha"))
    bench = spec.load_json(root / "BENCHMARK.json")
    conf = spec.load_json(root / "benchmark" / "configs" / "sha256-2e20.json")
    circuit = reference_sha256.Sha256Circuit(3, rounds=2)
    nnz = sum(len(row) for rows in (circuit.A, circuit.B, circuit.C) for row in rows)
    conf.update(name=CONFIG, message_bytes=3, rounds=2, constraints=circuit.n_constraints,
                signals=circuit.n_signals, nonzeros=nnz, domain=reference.domain_size(circuit.n_constraints))
    (root / "benchmark" / "configs" / f"{CONFIG}.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": CONFIG, "source": "https://example.org/tiny", "reduced": ["rounds", "message_bytes"],
                             "file": f"benchmark/configs/{CONFIG}.json", "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "closed-message4", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ON_CPU and "workloads" in m:
            assert LIKE in m["workloads"], m["name"]
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root, trace):
    cell = cells.load(root, CELL)
    return harness.run_cell(cell, cells.SEED, 0.01, trace, time.perf_counter(), device="cpu")[0]


def test_clean_run_is_correct(tiny_root):
    """Traced (spans on in the window): every per-layer metric the CPU can
    read reads, the re-run time among them (0.0 where no flag fired)."""
    line = _run(tiny_root, True)
    assert line["correct"] and line["checks"]["wrong_answers"]["value"] == 0
    assert line["checks"]["wrong_answers"]["compared"] >= 1
    assert set(line["metrics"]) == set(ON_CPU) - {"prove_s", "setup_s"}
    assert line["metrics"]["rerun_ms.prove"]["value"] >= 0.0
    setup = line["setup"]
    assert {"circuit_s", "witness_s", "trusted_setup_s"} <= set(setup)
    assert 0.3 < setup["zero_share"] < 0.7 and 0.3 < setup["one_share"] < 0.7


def test_planted_fault_is_not_correct(tiny_root, monkeypatch):
    """Every proof's C moved by G1 where the prover assembles it."""
    from go_snark_study_tpu_torch.models import groth16_fast
    from go_snark_study_tpu_torch.models.groth16 import Proof

    orig = groth16_fast.FastGroth16.prove

    def altered(self, r1cs, pk, rng=None):
        p = orig(self, r1cs, pk, rng)
        g1 = self.ctx.bn.g1
        return Proof(pi_a=p.pi_a, pi_b=p.pi_b, pi_c=g1.add(p.pi_c, g1.g))

    monkeypatch.setattr(groth16_fast.FastGroth16, "prove", altered)
    line = _run(tiny_root, False)
    assert line["correct"] is False and line["checks"]["wrong_answers"]["value"] >= 1


def test_rerun_reader():
    cell = spec.load_cell(LIKE)
    read = cell.readers["rerun_ms.prove"]
    run = harness.Run(cell=cell, requests=[(0, 1)] * 4, spans={"prove.flags": [0.2, 4]})
    assert read(run) == 0.0  # a clean window: the flags read, nothing re-run
    run.spans["prove.rerun"] = [0.02, 1]
    assert read(run) == pytest.approx(5.0)
    run.spans = {}
    assert read(run) is None  # no flag span: nothing read


def test_config_matches_the_program_at_small_sizes():
    """The program's circuit and the reference's agree on the counts the
    configuration states, at one block (the full size is checked in
    set-up on the card)."""
    from go_snark_study_tpu_torch.circuits import sha256

    conf = spec.load_json(spec.PACKAGE_DIR / "configs" / "sha256-2e20.json")
    assert conf["constraints"] <= conf["domain"] == 1 << 20 and conf["public"] == 256
    assert conf["rounds"] == 64 and (8 * conf["message_bytes"] + 64) // 512 + 1 == 32
    r1cs, circuit = sha256.sha256_r1cs(55), reference_sha256.Sha256Circuit(55)
    assert (r1cs.n_constraints, r1cs.n_signals) == (circuit.n_constraints, circuit.n_signals)


def test_reference_imports_nothing_of_the_program():
    for mod in _imports(spec.PACKAGE_DIR / "reference_sha256.py"):
        assert not mod.split(".")[0].startswith("go_snark_study_tpu"), mod
        assert mod.split(".")[0] not in harness.FORBIDDEN_TOP_LEVEL, mod
    code = ("import sys, benchmark.reference_sha256 as r; c = r.Sha256Circuit(1, 1); c.witness(b'x'); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO_ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not {m for m in loaded if m.startswith("go_snark_study_tpu") or m in harness.FORBIDDEN_TOP_LEVEL}
