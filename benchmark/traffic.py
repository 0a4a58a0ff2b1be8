"""The one traffic generator: every mix is a JSON file of parameters under
``benchmark/traffic/`` that this module reads.

Parameters (keys of the file):

* ``loop``: "closed" (the next request is sent when the last returns);
  ``clients``: 1.
* ``pool``: how many distinct inputs are made in set-up; request i takes
  input i mod pool.
* ``scalars``, for a pool of MSM scalar vectors (a proof's pool holds
  multiplication chains' witnesses, each from its own seeded (s1, s2)):
  ``{"dist": "uniform"}``, canonical values below r, or ``{"dist": "num2bits", "run": 33, "word_bits": 32}``, runs of
  ``run`` lanes of which the first run - 1 hold a random bit and the last a
  random ``word_bits``-bit word (the witness of circomlib's Num2Bits).
  Num2Bits vectors are drawn on the device, from the seed, in blocks; only
  their low limb is kept.  Whether such sparse scalars fire the MSM's
  degeneracy re-run depends on their values, so the pool is large (1,024
  vectors): the share that fires is then much the same from seed to seed.
* ``scalar_bits``: the width the scalars span (the control drops its top
  bit).
* ``trace_requests``: the requests that ``--trace 1`` profiles after the
  window (twice: with the program's spans off, then on).
* ``check_sample``: at most this many answers are compared with the
  reference, drawn from the seed (every answer where fewer).

Every draw comes from ``--seed`` and a name, so that a seed gives the same
inputs whatever else a run draws, and every seed gives the same sizes.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
R_TOP_LIMB = R >> 224


class Traffic:
    def __init__(self, params: dict, seed: int):
        if params.get("loop") != "closed" or int(params.get("clients", 1)) != 1:
            raise ValueError(f"unsupported loop {params.get('loop')!r} x {params.get('clients')} clients")
        self.params = params
        self.seed = int(seed)
        self.pool = int(params["pool"])
        self.scalar_bits = int(params["scalar_bits"])
        self.trace_requests = int(params["trace_requests"])
        self.check_sample = int(params["check_sample"])

    def rng(self, name: str) -> random.Random:
        """A Python generator for the draws called ``name``."""
        return random.Random(f"{self.seed}/{name}")

    def np_rng(self, name: str, index: int = 0) -> np.random.Generator:
        tag = [ord(ch) for ch in name]
        return np.random.Generator(np.random.PCG64(np.random.SeedSequence([self.seed % (1 << 64), index, *tag])))

    def input_index(self, i: int) -> int:
        return i % self.pool

    # -- witnesses -----------------------------------------------------------
    def chain_seeds(self) -> List[Tuple[int, int]]:
        """(s1, s2) of each pool witness, each in [2, r)."""
        rng = self.rng("witness")
        return [(rng.randrange(2, R), rng.randrange(2, R)) for _ in range(self.pool)]

    @staticmethod
    def chain_witness(n: int, s1: int, s2: int) -> List[int]:
        """[1, out, s_1, ..., s_{n+1}], s_{k+1} = s_k * s_{k-1} mod r."""
        chain = [s1, s2]
        for _ in range(n - 1):
            chain.append(chain[-1] * chain[-2] % R)
        return [1, chain[-1]] + chain

    # -- scalar vectors ------------------------------------------------------
    def uniform_limbs(self, n: int, name: str, index: int = 0, odd: bool = False) -> np.ndarray:
        """(8, n) uint32 limbs of values below r (the top limb below r's);
        ``odd`` sets bit 0, so that no value is 0."""
        x = self.np_rng(name, index).integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
        x[7] %= R_TOP_LIMB
        if odd:
            x[0] |= 1
        return x.astype(np.uint32)

    def torch_seed(self, name: str) -> int:
        """A 63-bit seed for a torch generator, from ``--seed`` and ``name``."""
        return self.rng(name).getrandbits(63)

    def scalar_pool(self, n: int, device) -> "ScalarPool":
        """The pool's scalar vectors as a :class:`ScalarPool` on ``device``."""
        import torch

        spec = self.params["scalars"]
        if spec["dist"] == "uniform":
            limbs = np.stack([self.uniform_limbs(n, "scalars", k) for k in range(self.pool)])
            return ScalarPool(torch.from_numpy(limbs.view(np.int32)).to(device))
        if spec["dist"] == "num2bits":
            low = torch.empty((self.pool, n), dtype=torch.int32, device=device)
            for a, block in self.num2bits_blocks(n, device):
                low[a : a + block.shape[0]] = block
            return ScalarPool(low.unsqueeze(1))
        raise ValueError(f"unknown scalar distribution {spec['dist']!r}")

    def num2bits_blocks(self, n: int, device, block: int = 64):
        """(first index, (b, n) int32 low limbs) of the Num2Bits pool, in
        blocks of ``block`` vectors: the same values on the same device for
        the same seed, whoever draws them."""
        import torch

        spec = self.params["scalars"]
        run, wbits = int(spec["run"]), int(spec["word_bits"])
        g = torch.Generator(device=device).manual_seed(self.torch_seed("scalars"))
        is_word = torch.arange(n, device=device) % run == run - 1
        lo, hi = (-(1 << 31), 1 << 31) if wbits == 32 else (0, 1 << wbits)
        for a in range(0, self.pool, block):
            shape = (min(block, self.pool - a), n)
            words = torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32)
            bits = torch.randint(0, 2, shape, generator=g, device=device, dtype=torch.int32)
            yield a, torch.where(is_word, words, bits)

    # -- requests and checks -------------------------------------------------
    def request_seed(self, i: int) -> str:
        """The seed of request i's own draws (a proof's blinding r, s)."""
        return f"{self.seed}/request/{i}"

    def sample(self, done: int) -> List[int]:
        """Indices of the completed requests to compare: all when at most
        ``check_sample``, else that many drawn from the seed, the first and
        last among them."""
        if done <= self.check_sample:
            return list(range(done))
        rest = self.rng("sample").sample(range(1, done - 1), self.check_sample - 2)
        return sorted({0, done - 1, *rest})


class ScalarPool:
    """Scalar vectors on the device: ``limbs`` (pool, L, n) int32, the
    low L of each vector's eight 32-bit limbs (the others are 0).  A
    request's (8, n) limbs are ``limbs[k]`` itself where L is 8, else a
    buffer whose low L rows take vector k's (one copy on the device)."""

    def __init__(self, limbs):
        import torch

        self.limbs = limbs
        self.size, self.width, self.n = limbs.shape
        self._buf = None if self.width == 8 else torch.zeros((8, self.n), dtype=torch.int32, device=limbs.device)

    def __getitem__(self, k: int):
        if self._buf is None:
            return self.limbs[k]
        self._buf[: self.width].copy_(self.limbs[k])
        return self._buf
