"""Dense polynomial arithmetic over a prime field (host parity path).

Copy of ``go_snark_study_tpu/r1csqap/polynomial.py`` (reference:
r1csqap/r1csqap.go).  Polynomials are Python lists of ints, dense, index
i = coefficient of x^i — the same encoding the reference serialises, so QAP
artifacts (alphas/betas/gammas/zx/px/hx) are comparable element by element.

Two deliberate divergences from the reference, kept from the JAX package:
  * ``new_pol_zero_at`` computes the Lagrange-basis denominator in the field
    instead of a native int factorial, which in the reference overflows int64
    beyond ~20 interpolation points (r1csqap.go:129-147) and caps circuit
    size.  For small n the values are identical.
  * nothing here is O(n^2)-free: this module is the *parity* path.  The
    n·log n evaluation-form path for large circuits is
    :mod:`go_snark_study_tpu_torch.models.groth16_fast` over
    :mod:`go_snark_study_tpu_torch.ops.ntt`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..fields import Fq

__all__ = [
    "PolynomialField",
    "transpose",
    "array_of_zeros",
    "arrays_equal",
]


def transpose(matrix: Sequence[Sequence[int]]) -> List[List[int]]:
    """Reference: r1csqap.go:11-21."""
    return [list(col) for col in zip(*matrix)]


def array_of_zeros(n: int) -> List[int]:
    return [0] * n


def arrays_equal(a: Sequence[int], b: Sequence[int]) -> bool:
    return len(a) == len(b) and all(x == y for x, y in zip(a, b))


class PolynomialField:
    """Polynomial ops over Fq.  Reference: r1csqap.go:45-216."""

    def __init__(self, f: Fq):
        self.F = f

    # -- basic ops ---------------------------------------------------------
    def mul(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        F = self.F
        r = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            if ai == 0:
                continue
            for j, bj in enumerate(b):
                r[i + j] = (r[i + j] + ai * bj) % F.q
        return r

    def div(self, a: Sequence[int], b: Sequence[int]) -> Tuple[List[int], List[int]]:
        """Long division: returns (quotient, remainder).  Mirrors the
        reference's loop shape (r1csqap.go:70-84) including the remainder
        convention (one coefficient dropped per step)."""
        F = self.F
        r = [0] * (len(a) - len(b) + 1)
        rem = list(a)
        while len(rem) >= len(b):
            lead = F.div(rem[-1], b[-1])
            pos = len(rem) - len(b)
            r[pos] = lead
            shifted = [0] * pos + [lead]
            rem = self.sub(rem, self.mul(b, shifted))[:-1]
        return r, rem

    def add(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        F = self.F
        r = [0] * max(len(a), len(b))
        for i, ai in enumerate(a):
            r[i] = ai % F.q
        for i, bi in enumerate(b):
            r[i] = (r[i] + bi) % F.q
        return r

    def sub(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        F = self.F
        r = [0] * max(len(a), len(b))
        for i, ai in enumerate(a):
            r[i] = ai % F.q
        for i, bi in enumerate(b):
            r[i] = (r[i] - bi) % F.q
        return r

    def eval(self, v: Sequence[int], x: int) -> int:
        """Horner evaluation (the reference's per-term Exp loop,
        r1csqap.go:118-126, computes the same value in O(n^2))."""
        F = self.F
        acc = 0
        for c in reversed(v):
            acc = (acc * x + c) % F.q
        return acc

    # -- Lagrange interpolation at x = 1..n --------------------------------
    def new_pol_zero_at(self, point_pos: int, total_points: int, height: int) -> List[int]:
        """Lagrange basis polynomial scaled to ``height`` at ``point_pos``
        (points are 1..total_points).  Reference: r1csqap.go:129-147, with the
        int64-factorial defect fixed by computing the denominator in-field."""
        F = self.F
        fac = 1
        for i in range(1, total_points + 1):
            if i != point_pos:
                fac = (fac * (point_pos - i)) % F.q
        r = [F.div(height, fac)]
        for i in range(1, total_points + 1):
            if i != point_pos:
                r = self.mul(r, [F.q - i, 1])
        return r

    def lagrange_interpolation(self, v: Sequence[int]) -> List[int]:
        """Interpolate values v at points x = 1..len(v).
        Reference: r1csqap.go:150-158."""
        r: List[int] = []
        for i, vi in enumerate(v):
            r = self.add(r, self.new_pol_zero_at(i + 1, len(v), vi))
        return r

    # -- QAP ---------------------------------------------------------------
    def r1cs_to_qap(self, a, b, c):
        """R1CS (constraint-major) -> QAP (signal-major interpolated polys)
        plus the vanishing polynomial z.  Reference: r1csqap.go:161-188.

        QUIRK preserved deliberately: z's roots are 1..len(alphas)-2, i.e.
        nSignals-2 — *not* the constraint count (r1csqap.go:178-187,
        snark.go:221-232).  Artifact parity depends on this."""
        at, bt, ct = transpose(a), transpose(b), transpose(c)
        alphas = [self.lagrange_interpolation(col) for col in at]
        betas = [self.lagrange_interpolation(col) for col in bt]
        gammas = [self.lagrange_interpolation(col) for col in ct]
        z = self.vanishing_reference(len(alphas))
        return alphas, betas, gammas, z

    def vanishing_reference(self, n_alphas: int) -> List[int]:
        """z(x) = prod_{i=1}^{n_alphas-2} (x - i), the reference's convention."""
        F = self.F
        z = [1]
        for i in range(1, n_alphas - 1):
            z = self.mul(z, [F.neg(i), 1])
        return z

    def combine_polynomials(self, r: Sequence[int], ap, bp, cp):
        """Witness-weighted combination and p = a*b - c.
        Reference: r1csqap.go:191-210."""
        ax: List[int] = []
        bx: List[int] = []
        cx: List[int] = []
        for i, ri in enumerate(r):
            ax = self.add(ax, self.mul([ri], ap[i]))
            bx = self.add(bx, self.mul([ri], bp[i]))
            cx = self.add(cx, self.mul([ri], cp[i]))
        px = self.sub(self.mul(ax, bx), cx)
        return ax, bx, cx, px

    def divisor_polynomial(self, px: Sequence[int], z: Sequence[int]) -> List[int]:
        """h = p / z (exact when the witness satisfies the R1CS).
        Reference: r1csqap.go:213-216."""
        return self.div(px, z)[0]
