"""Keccak-256 in the port (``go_snark_study_tpu_torch.circuits.keccak``)
against its plain reference (``benchmark/reference_keccak.py``, the
benchmark's, which imports nothing of the port), ``hashlib.sha3_256`` and
FIPS 202: the full 24-round circuit over one and two blocks row for row, the
configuration's counts, a one-round circuit proven on the CPU against the
closed form and the verifier (``slow``: about 18 minutes on the plain
kernels), and, on the card, the 1,767-byte circuit of the benchmark's
``keccak256-2e21``.  Imports no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_keccak.py`` runs on
the card."""

import ast
import hashlib
import json
import os
import random
from pathlib import Path

import pytest
import torch

from benchmark import reference_keccak as ref
from go_snark_study_tpu_torch import profiling
from go_snark_study_tpu_torch.circuits import keccak
from go_snark_study_tpu_torch.models.groth16 import verify_proof

# the tier-1 run gives each of its workers a share of the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "benchmark" / "configs" / "keccak256-2e21.json"
ROWS_PER_PERMUTATION = 24 * 6400 + 86  # theta and chi, and iota's 86 one bits
LENGTHS = (0, 135, 136, 271)  # one block; one block ending in 0x81; a padding block; two with 0x81

# FIPS 202 table 2 (as in the Keccak reference) and the rho offsets r[x, y]
FIPS_RC = (0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
           0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
           0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
           0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
           0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
           0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008)
FIPS_RHO = {(0, 0): 0, (1, 0): 1, (2, 0): 190 % 64, (3, 0): 28, (4, 0): 91 % 64,
            (0, 1): 36, (1, 1): 300 % 64, (2, 1): 6, (3, 1): 55, (4, 1): 276 % 64,
            (0, 2): 3, (1, 2): 10, (2, 2): 171 % 64, (3, 2): 153 % 64, (4, 2): 231 % 64,
            (0, 3): 105 % 64, (1, 3): 45, (2, 3): 15, (3, 3): 21, (4, 3): 136 % 64,
            (0, 4): 210 % 64, (1, 4): 66 % 64, (2, 4): 253 % 64, (3, 4): 120 % 64, (4, 4): 78 % 64}


def _message(n: int) -> bytes:
    return random.Random(2**31 + n).randbytes(n)


@pytest.fixture(scope="module")
def circuits():
    """n -> the full circuit for n bytes, with the witness of _message(n)."""
    out = {}
    for n in LENGTHS:
        r1cs = keccak.keccak_r1cs(n)
        r1cs.witness = keccak.witness(r1cs, _message(n))
        out[n] = r1cs
    return out


def test_constants_are_fips_202():
    assert keccak.RC == FIPS_RC and tuple(ref.ROUND_CONSTANTS) == FIPS_RC
    assert sum(bin(rc).count("1") for rc in FIPS_RC) == 86
    for (x, y), r in FIPS_RHO.items():
        assert keccak.RHO[x + 5 * y] == r == ref.ROTATIONS[x][y], (x, y)


def test_reference_sponge_is_keccak256_and_sha3():
    """The reference's permutation, through the sponge with 0x06, is
    hashlib's SHA3-256; with 0x01 it is Keccak-256 (its published digests
    of "" and "abc")."""
    for n in LENGTHS + (1, 1767):
        msg = _message(n)
        assert ref.sponge(msg, 0x06) == hashlib.sha3_256(msg).digest(), n
    assert ref.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert ref.keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


def test_reference_imports_nothing_of_the_program():
    """The reference and the modules it imports hold the port to an answer
    made apart from it: none imports the port, the JAX package or JAX."""
    for name in ("reference_keccak.py", "reference_sha256.py", "reference.py"):
        tree = ast.parse((ROOT / "benchmark" / name).read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert mods, name
        for mod in mods:
            assert mod.split(".")[0] not in ("go_snark_study_tpu_torch", "go_snark_study_tpu", "jax"), (name, mod)


@pytest.mark.parametrize("n", LENGTHS)
def test_full_circuit_is_keccak256(circuits, n):
    r1cs, msg = circuits[n], _message(n)
    assert r1cs.check()
    assert keccak.digest(r1cs.witness) == ref.keccak256(msg)
    blocks = n // 136 + 1
    pad = bytearray(136 * blocks - n)
    pad[0] |= 0x01
    pad[-1] |= 0x80
    absorbed = 8 * max(0, n - 136) + sum(bin(p).count("1") for p in pad[max(0, 136 - n):])
    assert r1cs.n_constraints == 9 * n + blocks * ROWS_PER_PERMUTATION + absorbed
    assert r1cs.n_signals == r1cs.n_constraints + 1 and r1cs.n_public == 256
    assert max(len(c) for c in r1cs.C) <= 9  # no row longer than a byte's sum


@pytest.mark.parametrize("n", [135, 271])
def test_rows_are_the_reference_row_for_row(circuits, n):
    r1cs, msg = circuits[n], _message(n)
    want = ref.KeccakCircuit(n)
    assert (want.n_constraints, want.n_signals) == (r1cs.n_constraints, r1cs.n_signals)
    assert r1cs.A == want.A and r1cs.B == want.B and r1cs.C == want.C
    assert r1cs.witness == want.witness(msg)


def test_configuration_counts_are_the_program_circuit():
    """``keccak256-2e21``'s counts: blocks 2..12 are alike, so the 13-block
    circuit is the 2-block one (1,767 - 11 x 136 = 271 bytes) and 11 times
    the step from 2 to 3 blocks; a 14th block would not fit the domain."""
    from benchmark.systems.groth16_keccak import SHAPE_KEYS, shape_of

    conf = json.loads(CONFIG.read_text())
    assert (conf["message_bytes"], conf["blocks"], conf["rounds"]) == (1767, 13, 24)
    two, three = shape_of(keccak.keccak_r1cs(271)), shape_of(keccak.keccak_r1cs(407))
    grow = lambda a, b: {k: grow(a[k], b[k]) for k in a} if isinstance(a, dict) else a + 11 * (b - a)
    assert grow(two, three) == {k: conf[k] for k in SHAPE_KEYS}
    assert conf["constraints"] <= conf["domain"] == 1 << 21
    step = three["constraints"] - two["constraints"]
    assert conf["constraints"] + step + 9 > conf["domain"]  # 1,768 bytes: 14 blocks


def test_a_flipped_bit_fails_the_check():
    msg = b"the quick brown fox"
    r1cs = keccak.keccak_r1cs(len(msg), rounds=2)
    good = keccak.witness(r1cs, msg)
    # a digest bit, a byte's bit, the last chi output
    for signal in (1, 1 + 256 + len(msg) + 3, len(good) - 1):
        r1cs.witness = list(good)
        r1cs.witness[signal] ^= 1
        assert not r1cs.check(), signal
    r1cs.witness = good
    assert r1cs.check()


def test_witness_wants_the_circuit_length():
    layout = keccak.keccak_r1cs(4, rounds=1).layout
    assert len(keccak.witness(layout, b"abcd")) == layout.n_signals
    with pytest.raises(ValueError):
        keccak.witness(layout, b"abc")
    with pytest.raises(ValueError):
        keccak.keccak_r1cs(4, rounds=25)


def test_circuit_spans(monkeypatch):
    monkeypatch.setattr(profiling, "PROFILER", profiling.Profiler())
    with profiling.profiling() as prof:
        r1cs = keccak.keccak_r1cs(2, rounds=1)
        keccak.witness(r1cs, b"hi")
    assert prof.calls == {"circuit.keccak.r1cs": 1, "circuit.keccak.witness": 1}


def test_card_engines_run_a_2e21_msm_in_one_group(monkeypatch):
    """On a card the prover's engines take its memory as the window-group
    budget: the 2^21 key's MSMs run their 20 windows in one group in G1 and
    in G2, where the JAX engine's 3 GiB made 5 and 10 (each 1,024 serial
    steps over 8,192 or 4,096 lanes).  On the CPU the engines keep the JAX
    engine's grouping."""
    from go_snark_study_tpu_torch.bn128 import constants as C
    from go_snark_study_tpu_torch.models import groth16_fast
    from go_snark_study_tpu_torch.ops.msm import MSMEngine

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: type("P", (), {"total_memory": 80 << 30}))
    budget = groth16_fast._group_budget(torch.device("cuda"))
    assert budget == {"group_bytes": 80 << 30} and groth16_fast._group_budget(torch.device("cpu")) == {}
    fast = groth16_fast.FastGroth16(device="cpu")
    conf = json.loads(CONFIG.read_text())
    for eng, want in ((fast.msm_g1, 5), (fast.msm_g2, 10)):
        assert eng.group_bytes == MSMEngine(None, None, C.R).group_bytes
        for n in (fast._pad_for(conf["signals"]), fast._pad_for(conf["domain"])):
            assert eng.layout(n)["groups"] == want, n
            card = MSMEngine(eng.bg, None, C.R, **budget).layout(n)
            assert (card["wg"], card["wpad"], card["groups"], card["k"]) == (20, 0, 1, n // 2048), n


def _check_proof(fast, r1cs, message, seed):
    """Set up and prove ``r1cs`` for ``message`` with ``fast``; the proof
    against the reference's closed form and the verifier."""
    from benchmark.reference import g1_affine, g2_affine
    from benchmark.reference_sha256 import Groth16Proofs

    r1cs.witness = keccak.witness(r1cs, message)
    rng = random.Random(seed)
    setup = fast.setup(r1cs, rng=rng, materialize_host=False)
    proof = fast.prove(r1cs, setup.pk, rng=rng)

    draws = random.Random(seed)
    toxic = [draws.randrange(ref.R) for _ in range(5)]
    r, s = draws.randrange(ref.R), draws.randrange(ref.R)
    circuit = ref.KeccakCircuit(len(message), r1cs.layout.rounds)
    proofs = Groth16Proofs(circuit.A, circuit.B, circuit.C, circuit.n_public, toxic)
    w = circuit.witness(message)
    want = proofs.proof(proofs.witness_terms(w), r, s)
    assert (g1_affine(proof.pi_a), g2_affine(proof.pi_b), g1_affine(proof.pi_c)) == want
    public = r1cs.witness[1:257]
    assert public == w[1:257]
    assert verify_proof(setup.vk, proof, public)
    assert not verify_proof(setup.vk, proof, [1 - public[0]] + public[1:])


@pytest.mark.slow
def test_one_round_circuit_proven_on_cpu():
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

    r1cs = keccak.keccak_r1cs(3, rounds=1)
    assert (r1cs.n_constraints, r1cs.n_signals) == (6428, 6429)  # the 2^13 domain
    _check_proof(FastGroth16(device="cpu"), r1cs, b"abc", 2**31 + 25)


@pytest.mark.gpu
def test_keccak_2e21_proof_on_card():
    """The benchmark's configuration: 1,767 bytes, 13 permutations, proven
    on the card at the 2^21 domain, against the reference and the
    verifier."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.systems.groth16_keccak import SHAPE_KEYS, shape_of
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

    conf = json.loads(CONFIG.read_text())
    r1cs = keccak.keccak_r1cs(conf["message_bytes"])
    assert shape_of(r1cs) == {k: conf[k] for k in SHAPE_KEYS}
    fast = FastGroth16()
    fast.warmup(families=(), domains=(conf["domain"],), g2=True)
    _check_proof(fast, r1cs, os.urandom(conf["message_bytes"]), 2**31 + 1767)
