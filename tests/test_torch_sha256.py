"""circomlib's SHA-256 in the port (``go_snark_study_tpu_torch.circuits.sha256``)
against its plain reference (``benchmark/reference_sha256.py``, the
benchmark's, which imports nothing of the port) and ``hashlib``: the full circuit over one
and two compressions row for row, a two-round circuit proven on the CPU
against the closed form and the verifier, and, on the card, the 1,984-byte
circuit of the benchmark's ``sha256-2e20``.  Imports no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_sha256.py`` runs on
the card."""

import ast
import hashlib
import os
import random
from pathlib import Path

import pytest
import torch

from benchmark import reference_sha256 as ref
from go_snark_study_tpu_torch import profiling
from go_snark_study_tpu_torch.circuits import sha256
from go_snark_study_tpu_torch.models.groth16 import verify_proof

# the tier-1 run gives each of its workers a share of the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ROWS_PER_BLOCK, SIGNALS_PER_BLOCK = 31264, 30952


def test_constants_are_fips_180_4():
    assert sha256.K[:2] == (0x428A2F98, 0x71374491) and sha256.K[63] == 0xC67178F2
    assert sha256.H0 == (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                         0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
    assert list(sha256.K) == ref.ROUND_K and list(sha256.H0) == ref.INITIAL_H


def test_reference_imports_nothing_of_the_program():
    """The reference and the module it imports hold the port to an answer
    made apart from it: neither imports the port, the JAX package or JAX."""
    for name in ("reference_sha256.py", "reference.py"):
        tree = ast.parse((ROOT / "benchmark" / name).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert mods, name
        for mod in mods:
            assert mod.split(".")[0] not in ("go_snark_study_tpu_torch", "go_snark_study_tpu", "jax"), (name, mod)


@pytest.mark.parametrize("n", [0, 55, 56, 64, 119])
def test_full_circuit_is_sha256_and_the_reference_row_for_row(n):
    msg = random.Random(n).randbytes(n)
    r1cs = sha256.sha256_r1cs(n)
    r1cs.witness = sha256.witness(r1cs, msg)
    assert r1cs.check()
    assert sha256.digest(r1cs.witness) == hashlib.sha256(msg).digest()
    blocks = 1 if n <= 55 else 2
    assert r1cs.n_constraints == blocks * ROWS_PER_BLOCK + 9 * n and r1cs.n_public == 256
    assert r1cs.n_signals == 1 + 9 * n + blocks * SIGNALS_PER_BLOCK
    want = ref.Sha256Circuit(n)
    assert (want.n_constraints, want.n_signals) == (r1cs.n_constraints, r1cs.n_signals)
    assert r1cs.A == want.A and r1cs.B == want.B and r1cs.C == want.C
    assert r1cs.witness == want.witness(msg)
    assert all(not a and not b for a, b, c in zip(r1cs.A, r1cs.B, r1cs.C) if len(c) > 64)  # dense rows are linear


def test_a_flipped_bit_fails_the_check():
    msg = b"the quick brown fox"
    r1cs = sha256.sha256_r1cs(len(msg))
    good = sha256.witness(r1cs, msg)
    for signal in (1, 1 + 256 + len(msg) + 3, len(good) - 40):  # a digest bit, a byte's bit, a last-block sum bit
        r1cs.witness = list(good)
        r1cs.witness[signal] ^= 1
        assert not r1cs.check(), signal
    r1cs.witness = good
    assert r1cs.check()


def test_witness_wants_the_circuit_length():
    layout = sha256.sha256_r1cs(4, rounds=1).layout
    assert len(sha256.witness(layout, b"abcd")) == layout.n_signals
    with pytest.raises(ValueError):
        sha256.witness(layout, b"abc")


def test_circuit_spans(monkeypatch):
    monkeypatch.setattr(profiling, "PROFILER", profiling.Profiler())
    with profiling.profiling() as prof:
        r1cs = sha256.sha256_r1cs(2, rounds=1)
        sha256.witness(r1cs, b"hi")
    assert prof.calls == {"circuit.sha256.r1cs": 1, "circuit.sha256.witness": 1}


def _check_proof(fast, r1cs, message, seed):
    """Set up and prove ``r1cs`` for ``message`` with ``fast``; the proof
    against the reference's closed form and the verifier."""
    from benchmark.reference import g1_affine, g2_affine

    r1cs.witness = sha256.witness(r1cs, message)
    rng = random.Random(seed)
    setup = fast.setup(r1cs, rng=rng, materialize_host=False)
    reruns0 = fast.msm_g1.fallback_hits + fast.msm_g2.fallback_hits
    proof = fast.prove(r1cs, setup.pk, rng=rng)
    assert sum(fast.rerun_counts.values()) == fast.msm_g1.fallback_hits + fast.msm_g2.fallback_hits - reruns0

    draws = random.Random(seed)
    toxic = [draws.randrange(ref.R) for _ in range(5)]
    r, s = draws.randrange(ref.R), draws.randrange(ref.R)
    circuit = ref.Sha256Circuit(len(message), r1cs.layout.rounds)
    proofs = ref.Groth16Proofs(circuit.A, circuit.B, circuit.C, circuit.n_public, toxic)
    w = circuit.witness(message)
    want = proofs.proof(proofs.witness_terms(w), r, s)
    assert (g1_affine(proof.pi_a), g2_affine(proof.pi_b), g1_affine(proof.pi_c)) == want
    public = r1cs.witness[1:257]
    assert public == w[1:257]
    assert verify_proof(setup.vk, proof, public)
    assert not verify_proof(setup.vk, proof, [1 - public[0]] + public[1:])


def test_two_round_circuit_proven_on_cpu():
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

    r1cs = sha256.sha256_r1cs(3, rounds=2)
    assert (r1cs.n_constraints, r1cs.n_signals) == (1023, 1008)  # the 2^10 domain
    _check_proof(FastGroth16(device="cpu"), r1cs, b"abc", 2**31 + 20)


@pytest.mark.gpu
def test_sha256_2e20_proof_on_card():
    """The benchmark's configuration: 1,984 bytes, 32 compressions, proven
    on the card, against the reference and the verifier."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

    conf = json.loads((ROOT / "benchmark" / "configs" / "sha256-2e20.json").read_text())
    r1cs = sha256.sha256_r1cs(conf["message_bytes"])
    nnz = sum(len(row) for rows in (r1cs.A, r1cs.B, r1cs.C) for row in rows)
    assert (r1cs.n_constraints, r1cs.n_signals, r1cs.n_public, nnz) == \
        (conf["constraints"], conf["signals"], conf["public"], conf["nonzeros"])
    fast = FastGroth16()
    fast.warmup(families=(), domains=(conf["domain"],), g2=True)
    _check_proof(fast, r1cs, os.urandom(conf["message_bytes"]), 2**31 + 1984)
