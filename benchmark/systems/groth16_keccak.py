"""A Groth16 deployment over Keccak-256, Ethereum's hash, of a fixed-length
message at the 2^21 domain: its proving key resident on the card, and proof
after proof against it.

The SHA-256 deployment (:mod:`benchmark.systems.groth16_sha256`) with
another circuit: set-up builds the program's own
(``go_snark_study_tpu_torch.circuits.keccak``), holds its shape to the
configuration's counts before the key is set up, and makes the pool's
witnesses; requests, the MSM work and the answers are the SHA-256 system's.
The reference (:mod:`benchmark.reference_keccak`) builds the circuit and
each witness on its own, holds each digest to its own keccak256, and works
out every compared proof in closed form
(:class:`benchmark.reference_sha256.Groth16Proofs`).
"""

from __future__ import annotations

import random
import time

from benchmark import cost, reference, reference_keccak, reference_sha256
from benchmark.systems import groth16_sha256

SHAPE_KEYS = ("constraints", "signals", "public", "nonzeros", "nonzeros_by_matrix", "linear_rows")


def shape_of(r1cs) -> dict:
    """The counts of a circuit that the configuration states."""
    by = {k: sum(map(len, getattr(r1cs, k))) for k in "ABC"}
    linear = sum(1 for a, b in zip(r1cs.A, r1cs.B) if not a and not b)
    return {"constraints": r1cs.n_constraints, "signals": r1cs.n_signals, "public": r1cs.n_public,
            "nonzeros": sum(by.values()), "nonzeros_by_matrix": by, "linear_rows": linear}


class System(groth16_sha256.System):
    def setup(self) -> dict:
        from go_snark_study_tpu_torch.circuits import keccak  # a program without the circuit stops here
        from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

        times = {}
        t0 = time.perf_counter()
        self.fast = FastGroth16(device=self.device)
        self.fast.warmup(families=(), domains=(self.size,), g2=True)
        self._fence()
        times["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.r1cs = keccak.keccak_r1cs(self.n_bytes, self.rounds)
        times["circuit_s"] = time.perf_counter() - t0
        shape, want = shape_of(self.r1cs), {k: self.config[k] for k in SHAPE_KEYS}
        if shape != want:
            raise ValueError(f"the program's circuit has {shape}, the configuration {want}")
        t0 = time.perf_counter()
        self.pool = [keccak.witness(self.r1cs, m) for m in self.messages()]
        times["witness_s"] = time.perf_counter() - t0
        self.digests = [keccak.digest(w) for w in self.pool]
        values = [v for w in self.pool for v in w]
        times["zero_share"] = values.count(0) / len(values)
        times["one_share"] = values.count(1) / len(values)
        lo = self.r1cs.n_public + 1
        limbs = groth16_sha256._limbs
        self.adds = [(cost.bucket_adds_exact(limbs(w)), cost.bucket_adds_exact(limbs(w[lo:]))) for w in self.pool]
        t0 = time.perf_counter()
        setup = self.fast.setup(self.r1cs, rng=self.traffic.rng("toxic"), materialize_host=False)
        self._fence()
        times["trusted_setup_s"] = time.perf_counter() - t0
        self.pk, self.vk = setup.pk, setup.vk
        return times

    def expected(self, indices, bits: int = 0) -> dict:
        """{request index: the reference's (A, B, C) in affine form, the
        digest of its own witness (its keccak256 at 24 rounds), True}; with
        ``bits`` the control's (private signals and the blinding pair one
        bit narrower: the witness's scalars are bits and bytes, so the pair
        carries the control)."""
        circuit = reference_keccak.KeccakCircuit(self.n_bytes, self.rounds)
        toxic_rng = self.traffic.rng("toxic")
        ref = reference_sha256.Groth16Proofs(circuit.A, circuit.B, circuit.C, circuit.n_public,
                                             [toxic_rng.randrange(reference.R) for _ in range(5)])
        messages = self.messages()
        out, terms, digests = {}, {}, {}
        for i in sorted(indices, key=self.traffic.input_index):
            k = self.traffic.input_index(i)
            if k not in terms:
                terms.clear()  # one witness's terms at a time
                w = circuit.witness(messages[k])  # its public bits held to the reference's keccak256
                terms[k], digests[k] = ref.witness_terms(w, bits), reference_keccak.digest(w)
            blind = random.Random(self.traffic.request_seed(i))
            r, s = blind.randrange(reference.R), blind.randrange(reference.R)
            if bits:
                r, s = reference.control_scalar(r, bits), reference.control_scalar(s, bits)
            out[i] = ref.proof(terms[k], r, s) + (digests[k], True)
        return out
