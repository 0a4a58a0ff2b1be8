"""Sparse R1CS instances: the DSL bridge and the synthetic benchmark chain.

Mirrors ``go_snark_study_tpu/synthetic.py``: ``SparseR1CS`` with
``from_circuit`` (the bridge from a DSL-compiled circuit to the fast prover)
and ``row_evals`` over the C++ sparse matvec (:mod:`.native`; the Python dot
product gives the same values where the library is not built), and
``mul_chain_r1cs``.  The fast prover takes the witness as bytes, never as
Python ints, written into its host buffer (``_witness_into``), and computes
the row evaluations on the device (:mod:`.ops.r1cs_spmv`); the host
products (``_products_into``, or returned as bytes by ``_row_evals_bytes``)
are its reference.

Shape of the chain: a multiplication chain  s_{k+1} = s_k * s_{k-1}  (mod r)
with one public output — every constraint row has O(1) nonzeros, like real
circuits.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from . import native
from .bn128.constants import R as FR_MOD

__all__ = ["SparseR1CS", "mul_chain_r1cs"]

_NATIVE_FR = None


def _native_fr():
    global _NATIVE_FR
    if _NATIVE_FR is None:
        _NATIVE_FR = native.NativeField(FR_MOD)
    return _NATIVE_FR


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

    @classmethod
    def from_circuit(cls, circuit, witness=None, r: int = FR_MOD) -> "SparseR1CS":
        """A DSL-compiled :class:`.circuitcompiler.Circuit` in the sparse
        form the fast prover consumes, so that flat-code circuits run
        through ``FastGroth16`` instead of the O(n^2) monomial parity path.

        If the circuit's dense R1CS has been generated it is used; otherwise
        the rows come straight from ``Circuit.generate_r1cs_sparse``, O(nnz)
        end to end.  The witness may be the raw-integer reference witness;
        it is reduced mod r here."""
        w = witness if witness is not None else circuit.witness
        if circuit.r1cs.A:
            rows = lambda dense: [{i: c % r for i, c in enumerate(row) if c % r} for row in dense]
            A, B, C = rows(circuit.r1cs.A), rows(circuit.r1cs.B), rows(circuit.r1cs.C)
        else:
            srows = lambda rs: [{i: c % r for i, c in row.items() if c % r} for row in rs]
            A, B, C = (srows(x) for x in circuit.generate_r1cs_sparse())
        return cls(
            n_constraints=len(A),
            n_signals=circuit.n_signals,
            n_public=circuit.n_public,
            A=A,
            B=B,
            C=C,
            witness=[x % r for x in w],
        )

    def check(self, r: int = FR_MOD) -> bool:
        w = self.witness
        dot = lambda row: sum(c * w[i] for i, c in row.items()) % r
        return all(
            dot(a) * dot(b) % r == dot(c)
            for a, b, c in zip(self.A, self.B, self.C)
        )

    def row_evals(self, r: int = FR_MOD) -> Tuple[List[int], List[int], List[int]]:
        """Witness-combined evaluations per constraint: (a_j, b_j, c_j) with
        a_j = <A_j, w> etc. — the evaluation-form inputs of the fast prover.
        Runs the C++ sparse matvec when the library is there and every
        coefficient fits its signed 64-bit slot, else the Python dot
        product; both give the same values.  The C++ route keeps the rows'
        CSR arrays after its first call (:meth:`_csr`)."""
        if r == FR_MOD:
            out = self._row_evals_native()
            if out is not None:
                return out
        return self._row_evals_python(r)

    def _row_evals_python(self, r: int = FR_MOD) -> Tuple[List[int], List[int], List[int]]:
        w = self.witness
        dot = lambda row: sum(c * w[i] for i, c in row.items()) % r
        return (
            [dot(row) for row in self.A],
            [dot(row) for row in self.B],
            [dot(row) for row in self.C],
        )

    def _csr(self):
        """(indptr, cols, signed vals) int64 arrays of A, B and C over Fr,
        built on first use and kept: the rows must not be edited after it.
        None if a coefficient has no signed 64-bit slot."""
        if not hasattr(self, "_csr_cache"):
            r, half, csr = FR_MOD, FR_MOD // 2, []
            for rows in (self.A, self.B, self.C):
                indptr = np.zeros(len(rows) + 1, dtype=np.int64)
                np.cumsum([len(row) for row in rows], out=indptr[1:])
                cols = np.fromiter((i for row in rows for i in row), dtype=np.int64, count=int(indptr[-1]))
                signed = [v if v <= half else v - r for row in rows for v in (c % r for c in row.values())]
                try:  # the library takes signed coefficients
                    csr.append((indptr, cols, np.array(signed, dtype=np.int64)))
                except OverflowError:
                    csr = None
                    break
            self._csr_cache = csr
        return self._csr_cache

    def _witness_into(self, w: np.ndarray) -> None:
        """The witness mod r into ``w``, a writable uint8 array of 32 bytes
        a signal (:func:`.native.ints_into`)."""
        native.ints_into(self.witness, FR_MOD, w)

    def _products_into(self, w: np.ndarray, outs) -> None:
        """The three row evaluations over Fr, from the witness as
        :meth:`_witness_into` wrote it into ``w``, into ``outs`` (three
        writable uint8 arrays of 32 bytes a row): the C++ sparse products
        where the library is there and every coefficient fits its signed
        64-bit slot, else the Python route's ints encoded; the same bytes."""
        csr = self._csr() if native.available() else None
        if csr is None:
            for out, v in zip(outs, self._row_evals_python(FR_MOD)):
                native.ints_into(v, FR_MOD, out)
            return
        nf = _native_fr()
        for (indptr, cols, vals), out in zip(csr, outs):
            nf.sparse_matvec_into(indptr, cols, vals, w, out)

    def _row_evals_native(self):
        """The C++ products decoded to ints, or None where they do not run."""
        if not native.available() or self._csr() is None:
            return None
        return tuple(native.ints_from_bytes(b) for b in self._row_evals_bytes()[:3])

    def _row_evals_bytes(self) -> Tuple[bytes, bytes, bytes, bytes]:
        """(a, b, c, w): the three row evaluations over Fr and the witness
        they share, each value canonical (< r) in 32 little-endian bytes,
        as ``bytes`` (:meth:`_witness_into`, then :meth:`_products_into`).
        Neither prover calls it: it is the host reference that the tests and
        ``chip_smoke.py`` hold the prover's SpMV to."""
        w = np.empty(32 * len(self.witness), dtype=np.uint8)
        outs = tuple(np.empty(32 * len(rows), dtype=np.uint8) for rows in (self.A, self.B, self.C))
        self._witness_into(w)
        self._products_into(w, outs)
        return tuple(x.tobytes() for x in outs + (w,))


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
