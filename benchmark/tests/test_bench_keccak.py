"""The Keccak-256 cell on the CPU: a tiny root with a one-round, one-block
copy of ``keccak256-2e21`` (a 3-byte message, 6,428 rows) run through the
harness on the program's plain kernels, and a planted fault that turns it
not correct (both ``slow``: each harness run proves twice on the plain
kernels, about 21 minutes); the circuit reader; the shape check of
set-up; and a reference that imports nothing of the program.

    python -m pytest -q benchmark/tests/test_bench_keccak.py            # the quick ones
    python -m pytest -q -m slow benchmark/tests/test_bench_keccak.py    # the two harness runs
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness, reference, reference_keccak, spec
from benchmark.tests import cells
from benchmark.tests.test_bench_harness import _imports

CELL, CONFIG, LIKE = "tiny-keccak", "tiny-keccak", "prove-keccak-2e21"
# what a run on the CPU can read of the cell's metrics (no device trace)
ON_CPU = ("prove_s", "setup_s", "trusted_setup_s", "bridge_ms.prove", "assembly_ms.prove", "gc_pause_ms.prove",
          "rerun_ms.prove", "circuit_s")


def _tiny_config() -> dict:
    from benchmark.systems.groth16_keccak import shape_of
    from go_snark_study_tpu_torch.circuits import keccak

    conf = spec.load_json(spec.PACKAGE_DIR / "configs" / "keccak256-2e21.json")
    r1cs = keccak.keccak_r1cs(3, rounds=1)
    conf.update(shape_of(r1cs), name=CONFIG, message_bytes=3, blocks=1, rounds=1,
                domain=reference.domain_size(r1cs.n_constraints))
    return conf


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = cells.make_root(tmp_path_factory.mktemp("keccak"))
    bench = spec.load_json(root / "BENCHMARK.json")
    (root / "benchmark" / "configs" / f"{CONFIG}.json").write_text(json.dumps(_tiny_config()))
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


@pytest.mark.slow
def test_clean_run_is_correct(tiny_root):
    """Traced (spans on in the window): every per-layer metric the CPU can
    read reads, the circuit's set-up time among them."""
    line = _run(tiny_root, True)
    assert line["correct"] and line["checks"]["wrong_answers"]["value"] == 0
    assert line["checks"]["wrong_answers"]["compared"] >= 1
    assert set(line["metrics"]) == set(ON_CPU) - {"prove_s", "setup_s"}
    assert line["metrics"]["circuit_s"]["value"] == line["setup"]["circuit_s"] > 0


@pytest.mark.slow
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


def test_circuit_reader():
    for name in ("prove-sha256-2e20", LIKE):
        cell = spec.load_cell(name)
        read = cell.readers["circuit_s"]
        assert read(harness.Run(cell=cell, setup={"circuit_s": 4.5, "witness_s": 0.5})) == 4.5
        assert read(harness.Run(cell=cell)) is None  # a system that builds no circuit reads nothing


def test_setup_refuses_another_shape(tiny_root):
    """The system stops before the key where the circuit is not the
    configuration's."""
    import torch

    from benchmark.traffic import Traffic

    cell = cells.load(tiny_root, CELL)
    system = cell.system(dict(cell.config, nonzeros_by_matrix={"A": 1, "B": 2, "C": 3}),
                         Traffic(cell.traffic, cells.SEED), torch.device("cpu"))
    with pytest.raises(ValueError, match="nonzeros_by_matrix"):
        system.setup()


def test_expected_digests_are_keccak256(tiny_root):
    """At 24 rounds the reference's witness spells keccak256; at the tiny
    cell's one round the expected digest is the witness's own."""
    from benchmark.traffic import Traffic

    import torch

    cell = cells.load(tiny_root, CELL)
    system = cell.system(cell.config, Traffic(cell.traffic, 2**40 + 3), torch.device("cpu"))
    want = system.expected([0, 1])
    msg = system.messages()[1]
    assert want[1][3] == reference_keccak.digest(reference_keccak.KeccakCircuit(3, 1).witness(msg))
    assert want[0][4] is True and len(want[0]) == 5
    full = reference_keccak.KeccakCircuit(3)
    assert reference_keccak.digest(full.witness(msg)) == reference_keccak.keccak256(msg)


def test_reference_imports_nothing_of_the_program():
    for mod in _imports(spec.PACKAGE_DIR / "reference_keccak.py"):
        assert not mod.split(".")[0].startswith("go_snark_study_tpu"), mod
        assert mod.split(".")[0] not in harness.FORBIDDEN_TOP_LEVEL, mod
    code = ("import sys, benchmark.reference_keccak as r; c = r.KeccakCircuit(1, 1); c.witness(b'x'); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO_ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not {m for m in loaded if m.startswith("go_snark_study_tpu") or m in harness.FORBIDDEN_TOP_LEVEL}
