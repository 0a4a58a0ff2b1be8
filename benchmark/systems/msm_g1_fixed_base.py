"""A G1 MSM deployment: n distinct points k_i*G resident on the card, made
there by the program's fixed-base engine from multipliers drawn from the
seed, and multi-scalar multiplication after multiplication over them.

Each request is what the port's bench times: the window sums with the
degeneracy re-run (``MSMEngine.window_sums_checked``) and the host
combination (``ops.msm.combine_window_sums``), over the traffic's next
scalar vector.  The reference's answer is (sum_i s_i*k_i)*G.
"""

from __future__ import annotations

import time

from benchmark import cost, reference


class System:
    def __init__(self, config: dict, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.n = int(config["points"])
        self.points_per_request = self.n
        self.fast = self.aff = self.c = self.scalars = None

    def _fence(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def multipliers(self):
        """(8, n) limbs of the points' multipliers k_i (odd, so non-zero)."""
        return self.traffic.uniform_limbs(self.n, "multipliers", odd=True)

    def _as_device(self, limbs):
        import torch

        return torch.from_numpy(limbs.view("int32")).to(self.device)

    def setup(self) -> dict:
        from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
        from go_snark_study_tpu_torch.ops.msm import digits_from_limbs

        times = {}
        t0 = time.perf_counter()
        self.fast = FastGroth16(device=self.device)
        self.fast.warmup(families=(), domains=(), g2=False, fixed_base=True)
        self._fence()
        times["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ks = self._as_device(self.multipliers())
        pts = self.fast.fb_g1.batch_mul_device(digits_from_limbs(ks, 8))
        self.aff = self.fast.g1b.to_affine_tiled(pts)
        del pts, ks
        self._fence()
        times["points_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.scalars = self.traffic.scalar_pool(self.n, self.device)
        self.c = self.fast.msm_g1.window_bits_for(self.n)
        self._fence()
        times["scalars_s"] = time.perf_counter() - t0
        return times

    def request(self, i: int):
        """One MSM over scalar vector i mod pool: the total, a host point."""
        from go_snark_study_tpu_torch.ops.msm import combine_window_sums

        fast = self.fast
        sums = fast.msm_g1.window_sums_checked(self.aff, self.scalars[self.traffic.input_index(i)], self.c)
        total = combine_window_sums(fast.ctx.bn.g1, fast.g1b.unpack(sums), self.c)
        self._fence()
        return total

    def reruns(self) -> int:
        """The engine's degeneracy re-runs so far."""
        return self.fast.msm_g1.fallback_hits

    def msm_works(self, i: int) -> list:
        """The work of request i's MSM (its scalars' non-zero digits
        counted at each window width)."""
        adds = cost.bucket_adds_exact(self.scalars[self.traffic.input_index(i)])
        return [cost.msm_work(self.n, 1, adds)]

    def release(self) -> None:
        self.fast = self.aff = self.scalars = None

    def expected(self, indices, bits: int = 0) -> dict:
        """{request index: (x, y) of the reference's total}; with ``bits``
        the control's (bit ``bits - 1`` of each scalar cleared).  The pool is
        drawn again from the seed and the sums taken in blocks of vectors."""
        import torch

        ks = self._as_device(self.multipliers())
        pool = self.traffic.scalar_pool(self.n, self.device).limbs
        want = sorted({self.traffic.input_index(i) for i in indices})
        totals = {}
        for a in range(0, len(want), 64):
            block = want[a : a + 64]
            rows = pool[torch.tensor(block, device=pool.device)]
            totals.update(zip(block, reference.msm_expected(rows, ks, bits)))
        del pool, ks
        return {i: totals[self.traffic.input_index(i)] for i in indices}

    @staticmethod
    def affine(answer):
        return reference.g1_affine(answer)
