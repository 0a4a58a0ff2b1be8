"""A Groth16 deployment over a real circuit: circomlib's SHA-256 of a
fixed-length message, its proving key resident on the card, and proof
after proof against it.

The program's entry, as for the multiplication chain:
``FastGroth16.setup(..., materialize_host=False)`` in set-up and
``FastGroth16.prove`` per request, over the program's own circuit
(``go_snark_study_tpu_torch.circuits.sha256``).  The traffic's pool is
messages of the configuration's length drawn from the seed; their witnesses
are made in set-up, as a prover service takes a witness calculated outside
the proof.  Request i proves message i mod pool with its own blinding
draws; its answer is the proof, the digest that the witness's public bits
spell, and whether the port's verifier accepted the cold request's proof.
The reference (:mod:`benchmark.reference_sha256`) builds the circuit and
each witness on its own and works out every compared proof in closed form.
"""

from __future__ import annotations

import random
import time

import numpy as np

from benchmark import cost, reference, reference_sha256


def _limbs(values):
    """(8, n) int32 torch limbs of ints below 2^256."""
    import torch

    raw = b"".join(v.to_bytes(32, "little") for v in values)
    u = np.frombuffer(raw, dtype=np.uint32).reshape(len(values), 8).T
    return torch.from_numpy(np.ascontiguousarray(u).view(np.int32))


class System:
    def __init__(self, config: dict, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.n_bytes = int(config["message_bytes"])
        self.rounds = int(config.get("rounds", 64))
        self.size = int(config["domain"])
        self.fast = self.r1cs = self.pk = self.vk = None
        self.pool, self.digests, self.adds = [], [], []
        self.verified = False

    def _fence(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def messages(self) -> list:
        """The pool's messages, from the seed."""
        rng = self.traffic.rng("messages")
        return [rng.randbytes(self.n_bytes) for _ in range(self.traffic.pool)]

    def setup(self) -> dict:
        from go_snark_study_tpu_torch.circuits import sha256  # a program without the circuit stops here
        from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16

        times = {}
        t0 = time.perf_counter()
        self.fast = FastGroth16(device=self.device)
        self.fast.warmup(families=(), domains=(self.size,), g2=True)
        self._fence()
        times["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.r1cs = sha256.sha256_r1cs(self.n_bytes, self.rounds)
        times["circuit_s"] = time.perf_counter() - t0
        nnz = sum(len(row) for rows in (self.r1cs.A, self.r1cs.B, self.r1cs.C) for row in rows)
        shape = (self.r1cs.n_constraints, self.r1cs.n_signals, self.r1cs.n_public, nnz)
        want = tuple(int(self.config[k]) for k in ("constraints", "signals", "public", "nonzeros"))
        if shape != want:
            raise ValueError(f"the program's circuit has (constraints, signals, public, nonzeros) {shape}, "
                             f"the configuration {want}")
        t0 = time.perf_counter()
        self.pool = [sha256.witness(self.r1cs, m) for m in self.messages()]
        times["witness_s"] = time.perf_counter() - t0
        self.digests = [sha256.digest(w) for w in self.pool]
        values = [v for w in self.pool for v in w]
        times["zero_share"] = values.count(0) / len(values)
        times["one_share"] = values.count(1) / len(values)
        lo = self.r1cs.n_public + 1
        self.adds = [(cost.bucket_adds_exact(_limbs(w)), cost.bucket_adds_exact(_limbs(w[lo:]))) for w in self.pool]
        t0 = time.perf_counter()
        setup = self.fast.setup(self.r1cs, rng=self.traffic.rng("toxic"), materialize_host=False)
        self._fence()
        times["trusted_setup_s"] = time.perf_counter() - t0
        self.pk, self.vk = setup.pk, setup.vk
        return times

    def request(self, i: int):
        """Prove message i mod pool: the proof's (A, B, C) host points and
        the digest of the witness proven.  The cold request's proof (i < 0,
        before the window) is held to the port's verifier, the 256 digest
        bits its public signals."""
        k = self.traffic.input_index(i)
        self.r1cs.witness = self.pool[k]
        proof = self.fast.prove(self.r1cs, self.pk, rng=random.Random(self.traffic.request_seed(i)))
        self._fence()
        if i < 0:
            from go_snark_study_tpu_torch.models.groth16 import verify_proof

            self.verified = bool(verify_proof(self.vk, proof, self.pool[k][1 : self.r1cs.n_public + 1]))
        return proof.pi_a, proof.pi_b, proof.pi_c, self.digests[k]

    def reruns(self) -> int:
        """The G1 and G2 engines' degeneracy re-runs so far."""
        return self.fast.msm_g1.fallback_hits + self.fast.msm_g2.fallback_hits

    def msm_works(self, i: int) -> list:
        """The work of one proof's five MSMs: A and B in G1 and B in G2 over
        the witness, C's over its private part, each counted from its own
        scalars (bits and bytes); H's over the domain, spanning Fr."""
        m, lo = int(self.config["signals"]), int(self.config["public"]) + 1
        full, priv = self.adds[self.traffic.input_index(i)]
        return [cost.msm_work(m, 1, full), cost.msm_work(m, 1, full), cost.msm_work(m, 2, full),
                cost.msm_work(m - lo, 1, priv), cost.msm_work(self.size, 1, cost.bucket_adds_uniform(self.size))]

    def release(self) -> None:
        self.fast = self.r1cs = self.pk = self.vk = None
        self.pool = []

    def expected(self, indices, bits: int = 0) -> dict:
        """{request index: the reference's (A, B, C) in affine form, the
        digest of its own witness (``hashlib.sha256``'s at 64 rounds), True};
        with ``bits`` the control's (private
        signals and the blinding pair one bit narrower: the witness's
        scalars are bits and bytes, so the pair carries the control)."""
        circuit = reference_sha256.Sha256Circuit(self.n_bytes, self.rounds)
        toxic_rng = self.traffic.rng("toxic")
        ref = reference_sha256.Groth16Proofs(circuit.A, circuit.B, circuit.C, circuit.n_public,
                                             [toxic_rng.randrange(reference.R) for _ in range(5)])
        messages = self.messages()
        out, terms, digests = {}, {}, {}
        for i in sorted(indices, key=self.traffic.input_index):
            k = self.traffic.input_index(i)
            if k not in terms:
                terms.clear()  # one witness's terms at a time
                w = circuit.witness(messages[k])  # its public bits held to hashlib's digest
                terms[k], digests[k] = ref.witness_terms(w, bits), reference_sha256.digest(w)
            blind = random.Random(self.traffic.request_seed(i))
            r, s = blind.randrange(reference.R), blind.randrange(reference.R)
            if bits:
                r, s = reference.control_scalar(r, bits), reference.control_scalar(s, bits)
            out[i] = ref.proof(terms[k], r, s) + (digests[k], True)
        return out

    def affine(self, answer) -> tuple:
        a, b, c, digest = answer
        return reference.g1_affine(a), reference.g2_affine(b), reference.g1_affine(c), digest, self.verified
