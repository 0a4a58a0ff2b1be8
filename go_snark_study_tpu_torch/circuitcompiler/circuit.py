"""Compiled circuit: R1CS generation + witness calculation (host).

Copy of ``go_snark_study_tpu/circuitcompiler/circuit.py`` (reference:
circuitcompiler/circuit.go).  Behavioural quirks preserved on
purpose, because golden-vector parity depends on them:

  * ``in`` constraints produce NO R1CS rows — the reference's per-input loop
    mutates scratch rows and then ``continue``s before appending
    (circuit.go:102-108), so only arithmetic constraints become rows.
  * ``-`` negates BOTH operands (insertVarNeg on V1 and V2,
    circuit.go:115-119).
  * the witness is computed over RAW integers with no field reduction, and
    ``/`` is Euclidean integer division exactly like Go's ``big.Int.Div``
    (circuit.go:173-184).  ``calculate_witness(..., field=fr)`` offers the
    field-semantics mode the reference lacks.
  * use-before-set is an error (the reference panics, circuit.go:63,76; we
    raise ``CircuitError``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = ["Circuit", "Constraint", "CircuitError"]


class CircuitError(Exception):
    pass


@dataclass
class Constraint:
    """One flat-code operation ``v1 op v2 = out``.
    Reference: circuit.go:29-39."""

    op: str = ""
    v1: str = ""
    v2: str = ""
    out: str = ""
    literal: str = ""
    private_inputs: List[str] = field(default_factory=list)  # func declarations
    public_inputs: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        """Go-style JSON field names (utils/base10parsers.go marshals
        Constraint verbatim with exported names)."""
        return {
            "Op": self.op,
            "V1": self.v1,
            "V2": self.v2,
            "Out": self.out,
            "Literal": self.literal,
            "PrivateInputs": self.private_inputs or None,
            "PublicInputs": self.public_inputs or None,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Constraint":
        return cls(
            op=d.get("Op", "") or "",
            v1=d.get("V1", "") or "",
            v2=d.get("V2", "") or "",
            out=d.get("Out", "") or "",
            literal=d.get("Literal", "") or "",
            private_inputs=list(d.get("PrivateInputs") or []),
            public_inputs=list(d.get("PublicInputs") or []),
        )


def _is_value(s: str) -> Optional[int]:
    """Go's strconv.Atoi on lexer identifier runs: digits only (the lexer
    emits '-' as its own token, so no signs appear here)."""
    if s and s.isdigit():
        return int(s)
    return None


def _go_div(x: int, y: int) -> int:
    """Go big.Int.Div: Euclidean division, remainder in [0, |y|)."""
    q, r = divmod(x, y)
    if r != 0 and y < 0:
        # python floors (r has sign of y); Euclidean wants r >= 0
        q += 1
    return q


@dataclass
class R1CS:
    A: List[List[int]] = field(default_factory=list)
    B: List[List[int]] = field(default_factory=list)
    C: List[List[int]] = field(default_factory=list)


@dataclass
class Circuit:
    """Reference: circuit.go:12-26.  Signal order is
    [one, publicInputs..., privateInputs..., intermediates...]."""

    n_vars: int = 0
    n_public: int = 0
    n_signals: int = 0
    private_inputs: List[str] = field(default_factory=list)
    public_inputs: List[str] = field(default_factory=list)
    signals: List[str] = field(default_factory=list)
    witness: List[int] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    r1cs: R1CS = field(default_factory=R1CS)

    # ------------------------------------------------------------------
    def _index_map(self) -> Dict[str, int]:
        """name -> index cache over ``signals`` (rebuilt when the list has
        grown — the parser appends, never reorders).  Turns the hot
        signal lookups from O(n) list scans into O(1), which is what makes
        2^16+-constraint DSL circuits compile in seconds instead of
        hours."""
        m = getattr(self, "_sig_cache", None)
        if m is None or len(m) != len(self.signals):
            m = {s: i for i, s in enumerate(self.signals)}
            self._sig_cache = m
        return m

    def _signal_index(self, name: str) -> int:
        try:
            return self._index_map()[name]
        except KeyError:
            raise CircuitError(f"unknown signal {name!r}")

    def _insert_var(self, arr: List[int], v: str, used: Dict[str, bool], sign: int) -> None:
        val = _is_value(v)
        if val is not None:
            arr[0] += val  # constants fold into column 0 ("one"); note the
            # reference adds the RAW value even for insertVarNeg
            # (circuit.go:70-81) — mirrored.
            return
        if not used.get(v):
            raise CircuitError(f"using variable before it's set: {v!r}")
        arr[self._signal_index(v)] += sign

    def generate_r1cs(self):
        """Flat code -> R1CS rows.  Reference: circuit.go:84-148."""
        a: List[List[int]] = []
        b: List[List[int]] = []
        c: List[List[int]] = []
        used: Dict[str, bool] = {}
        n = len(self.signals)
        for cons in self.constraints:
            row_a, row_b, row_c = [0] * n, [0] * n, [0] * n
            used[cons.out] = True
            if cons.op == "in":
                # produces no R1CS row (reference's continue-before-append,
                # circuit.go:102-108) — it only marks the input as set.
                continue
            elif cons.op == "+":
                row_c[self._signal_index(cons.out)] = 1
                self._insert_var(row_a, cons.v1, used, +1)
                self._insert_var(row_a, cons.v2, used, +1)
                row_b[0] = 1
            elif cons.op == "-":
                row_c[self._signal_index(cons.out)] = 1
                self._insert_var(row_a, cons.v1, used, -1)
                self._insert_var(row_a, cons.v2, used, -1)
                row_b[0] = 1
            elif cons.op == "*":
                row_c[self._signal_index(cons.out)] = 1
                self._insert_var(row_a, cons.v1, used, +1)
                self._insert_var(row_b, cons.v2, used, +1)
            elif cons.op == "/":
                self._insert_var(row_c, cons.v1, used, +1)
                row_c[self._signal_index(cons.out)] = 1
                self._insert_var(row_b, cons.v2, used, +1)
            else:
                # func declarations etc. never reach generate_r1cs in the
                # reference because main's constraint list has only in/ops
                continue
            a.append(row_a)
            b.append(row_b)
            c.append(row_c)
        self.r1cs = R1CS(a, b, c)
        return a, b, c

    def generate_r1cs_sparse(self):
        """Flat code -> sparse R1CS rows ({signal_index: coeff} dicts),
        bit-equivalent to :meth:`generate_r1cs` but O(nnz) instead of
        O(n_constraints x n_signals) — the dense form is memory-impossible
        beyond ~2^14 constraints (a 2^18 circuit would need 2^36 cells).
        The dense reference semantics (circuit.go:84-148) are mirrored
        statement for statement, including the ``=``-assignment of the out
        coefficient after the ``+=`` inserts."""
        a: List[Dict[int, int]] = []
        b: List[Dict[int, int]] = []
        c: List[Dict[int, int]] = []
        used: Dict[str, bool] = {}
        idx = self._index_map()

        def ins(row: Dict[int, int], v: str, sign: int) -> None:
            val = _is_value(v)
            if val is not None:
                row[0] = row.get(0, 0) + val  # raw value even for neg —
                # mirrors the reference's insertVarNeg (circuit.go:70-81)
                return
            if not used.get(v):
                raise CircuitError(f"using variable before it's set: {v!r}")
            i = idx[v]
            row[i] = row.get(i, 0) + sign

        for cons in self.constraints:
            row_a: Dict[int, int] = {}
            row_b: Dict[int, int] = {}
            row_c: Dict[int, int] = {}
            used[cons.out] = True
            if cons.op == "in":
                continue
            elif cons.op == "+":
                row_c[idx[cons.out]] = 1
                ins(row_a, cons.v1, +1)
                ins(row_a, cons.v2, +1)
                row_b[0] = 1
            elif cons.op == "-":
                row_c[idx[cons.out]] = 1
                ins(row_a, cons.v1, -1)
                ins(row_a, cons.v2, -1)
                row_b[0] = 1
            elif cons.op == "*":
                row_c[idx[cons.out]] = 1
                ins(row_a, cons.v1, +1)
                ins(row_b, cons.v2, +1)
            elif cons.op == "/":
                ins(row_c, cons.v1, +1)
                row_c[idx[cons.out]] = 1
                ins(row_b, cons.v2, +1)
            else:
                continue
            a.append(row_a)
            b.append(row_b)
            c.append(row_c)
        return a, b, c

    # ------------------------------------------------------------------
    def _grab(self, w: List[int], v: str):
        val = _is_value(v)
        if val is not None:
            return val
        return w[self._signal_index(v)]

    def calculate_witness(
        self,
        private_inputs: Sequence[int],
        public_inputs: Sequence[int],
        field_modulus: Optional[int] = None,
    ) -> List[int]:
        """Sequential constraint evaluation.  Reference: circuit.go:158-186
        (raw-integer semantics).  Pass ``field_modulus`` for the mod-r
        field-semantics mode (an extension; the reference has none)."""
        if len(private_inputs) != len(self.private_inputs):
            raise CircuitError("given privateInputs != circuit.PrivateInputs")
        if len(public_inputs) != len(self.public_inputs):
            raise CircuitError("given publicInputs != circuit.PublicInputs")
        w = [0] * len(self.signals)
        w[0] = 1
        for i, x in enumerate(public_inputs):
            w[i + 1] = x
        for i, x in enumerate(private_inputs):
            w[i + len(public_inputs) + 1] = x
        m = field_modulus
        if m is not None and len(self.constraints) >= 256:
            native_w = self._witness_native(w, m)
            if native_w is not None:
                self.witness = native_w
                return native_w
        for cons in self.constraints:
            if cons.op == "in":
                continue
            v1 = self._grab(w, cons.v1)
            v2 = self._grab(w, cons.v2)
            if cons.op == "+":
                r = v1 + v2
            elif cons.op == "-":
                r = v1 - v2
            elif cons.op == "*":
                r = v1 * v2
            elif cons.op == "/":
                if m is None:
                    r = _go_div(v1, v2)
                else:
                    r = (v1 * pow(v2, -1, m)) % m
            else:
                continue
            if m is not None:
                r %= m
            w[self._signal_index(cons.out)] = r
        self.witness = w
        return w

    def _witness_native(self, seeded: List[int], modulus: int) -> Optional[List[int]]:
        """Field-mode witness evaluation through the C++ runtime, or None
        when the library is not there (the caller then runs the Python
        loop).  A failure inside the library raises."""
        import numpy as np

        from .. import native

        if not native.available():
            return None
        OPS = {"+": 0, "-": 1, "*": 2, "/": 3, "in": 4}
        sig_idx = self._index_map()
        rows = []
        for cons in self.constraints:
            if cons.op not in OPS:
                continue
            enc = [OPS[cons.op], 0, 0, 0, 0, 0, 0]
            if cons.op != "in":
                for slot, name in ((1, cons.v1), (3, cons.v2)):
                    val = _is_value(name)
                    if val is not None:
                        if val >= 1 << 63:  # no int64 slot: the Python loop
                            return None
                        enc[slot], enc[slot + 1] = 0, val
                    else:
                        enc[slot], enc[slot + 1] = 1, sig_idx[name]
                enc[5] = sig_idx[cons.out]
            rows.append(enc)
        nf = native.NativeField(modulus)
        return nf.witness_eval(np.asarray(rows, dtype=np.int64), seeded)
