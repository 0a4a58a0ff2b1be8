"""Synthetic R1CS instances for benchmarking and scale testing.

Mirrors ``go_snark_study_tpu/synthetic.py``: ``SparseR1CS`` and
``mul_chain_r1cs``.  Trimmed: no C++ ``native`` sparse matvec (``row_evals``
is the plain Python dot product, which gives the same values) and no
``from_circuit`` bridge from the flat-code DSL, which the port does not have
yet.

Shape: a multiplication chain  s_{k+1} = s_k * s_{k-1}  (mod r) with one
public output — every constraint row has O(1) nonzeros, like real circuits.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .bn128.constants import R as FR_MOD

__all__ = ["SparseR1CS", "mul_chain_r1cs"]


@dataclass
class SparseR1CS:
    """Sparse constraint system over Fr.

    rows are dicts {signal_index: coeff}; signal 0 is the constant one.
    Layout mirrors the reference: [one, publics..., privates/intermediates].
    """

    n_constraints: int
    n_signals: int
    n_public: int
    A: List[Dict[int, int]] = field(default_factory=list)
    B: List[Dict[int, int]] = field(default_factory=list)
    C: List[Dict[int, int]] = field(default_factory=list)
    witness: List[int] = field(default_factory=list)

    def check(self, r: int = FR_MOD) -> bool:
        w = self.witness
        dot = lambda row: sum(c * w[i] for i, c in row.items()) % r
        return all(
            dot(a) * dot(b) % r == dot(c)
            for a, b, c in zip(self.A, self.B, self.C)
        )

    def row_evals(self, r: int = FR_MOD) -> Tuple[List[int], List[int], List[int]]:
        """Witness-combined evaluations per constraint: (a_j, b_j, c_j) with
        a_j = <A_j, w> etc. — the evaluation-form inputs of the fast prover."""
        w = self.witness
        dot = lambda row: sum(c * w[i] for i, c in row.items()) % r
        return (
            [dot(row) for row in self.A],
            [dot(row) for row in self.B],
            [dot(row) for row in self.C],
        )


def mul_chain_r1cs(n_constraints: int, seed: int = 0) -> SparseR1CS:
    """A satisfiable chain:  s_{k+1} = s_k * s_{k-1}  over Fr.

    Signals: [one, out(public), s_1, s_2, ..., s_{n+1}] where the last chain
    value is constrained equal to the public output by the final constraint
    (out * 1 = s_last)."""
    r = FR_MOD
    rng = random.Random(seed)
    s1, s2 = rng.randrange(2, r), rng.randrange(2, r)
    sys_ = SparseR1CS(
        n_constraints=n_constraints,
        n_signals=n_constraints + 3,
        n_public=1,
    )
    # witness: [one, out, s1, s2, s3, ...]
    chain = [s1, s2]
    for _ in range(n_constraints - 1):
        chain.append(chain[-1] * chain[-2] % r)
    out = chain[-1]
    sys_.witness = [1, out] + chain
    # chain constraints: chain[k+1] = chain[k] * chain[k-1]
    # signal index of chain[k] is 2 + k
    for k in range(n_constraints - 1):
        sys_.A.append({2 + k + 1: 1})
        sys_.B.append({2 + k: 1})
        sys_.C.append({2 + k + 2: 1})
    # output binding: out * 1 = chain[-1]
    sys_.A.append({1: 1})
    sys_.B.append({0: 1})
    sys_.C.append({2 + len(chain) - 1: 1})
    assert len(sys_.A) == n_constraints
    return sys_
