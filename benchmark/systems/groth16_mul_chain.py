"""A Groth16 deployment: one multiplication-chain circuit, its proving key
resident on the card, and proof after proof against it.

The program's entry: ``FastGroth16.setup(..., materialize_host=False)`` in
set-up, ``FastGroth16.prove`` per request.  The circuit's rows come from the
program's ``mul_chain_r1cs``; each request proves the next witness of the
traffic's pool (a chain from its own (s1, s2)) with its own blinding draws.
The reference (:mod:`benchmark.reference`) works out every compared proof
from the seed alone.
"""

from __future__ import annotations

import random
import time

from benchmark import cost, reference


class System:
    def __init__(self, config: dict, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.n = int(config["constraints"])
        self.size = reference.domain_size(self.n)
        self.fast = self.r1cs = self.pk = None
        self.pool = []

    def _fence(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def setup(self) -> dict:
        from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
        from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

        times = {}
        t0 = time.perf_counter()
        self.fast = FastGroth16(device=self.device)
        self.fast.warmup(families=(), domains=(self.size,), g2=True)
        self._fence()
        times["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.r1cs = mul_chain_r1cs(self.n, seed=0)
        if self.r1cs.n_signals != int(self.config["signals"]) or self.r1cs.n_public != int(self.config["public"]):
            raise ValueError("the program's chain does not have the configuration's shape")
        self.pool = [self.traffic.chain_witness(self.n, s1, s2) for s1, s2 in self.traffic.chain_seeds()]
        times["circuit_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        setup = self.fast.setup(self.r1cs, rng=self.traffic.rng("toxic"), materialize_host=False)
        self._fence()
        times["trusted_setup_s"] = time.perf_counter() - t0
        self.pk = setup.pk
        return times

    def request(self, i: int):
        """Prove witness i mod pool; the proof's (A, B, C) host points."""
        self.r1cs.witness = self.pool[self.traffic.input_index(i)]
        proof = self.fast.prove(self.r1cs, self.pk, rng=random.Random(self.traffic.request_seed(i)))
        self._fence()
        return proof.pi_a, proof.pi_b, proof.pi_c

    def reruns(self) -> int:
        """The G1 and G2 engines' degeneracy re-runs so far."""
        return self.fast.msm_g1.fallback_hits + self.fast.msm_g2.fallback_hits

    def msm_works(self, i: int) -> list:
        """The work of one proof's five MSMs, the same for every i, their
        scalars spanning Fr: three over the m signals (A and B in G1, B in
        G2), one over the private signals, one over the domain (H)."""
        m, lo = int(self.config["signals"]), int(self.config["public"]) + 1
        shapes = ((m, 1), (m, 1), (m, 2), (m - lo, 1), (self.size, 1))
        return [cost.msm_work(k, g, cost.bucket_adds_uniform(k)) for k, g in shapes]

    def release(self) -> None:
        self.fast = self.r1cs = self.pk = None
        self.pool = []

    def expected(self, indices, bits: int = 0) -> dict:
        """{request index: the reference's (A, B, C) in affine form}; with
        ``bits`` the control's (private signals one bit narrower)."""
        toxic_rng = self.traffic.rng("toxic")
        ref = reference.ChainProofs(self.n, [toxic_rng.randrange(reference.R) for _ in range(5)])
        seeds = self.traffic.chain_seeds()
        out, terms = {}, {}
        for i in sorted(indices, key=self.traffic.input_index):
            k = self.traffic.input_index(i)
            if k not in terms:
                terms.clear()  # one witness's terms at a time
                terms[k] = ref.witness_terms(reference.mul_chain_witness(self.n, *seeds[k]), bits)
            blind = random.Random(self.traffic.request_seed(i))
            r, s = blind.randrange(reference.R), blind.randrange(reference.R)
            out[i] = ref.proof(terms[k], r, s)
        return out

    @staticmethod
    def affine(answer) -> tuple:
        a, b, c = answer
        return reference.g1_affine(a), reference.g2_affine(b), reference.g1_affine(c)
