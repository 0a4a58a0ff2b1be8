"""Extension-field tower Fq2/Fq6/Fq12 (host / exact path).

Copy of ``go_snark_study_tpu/fields/tower.py``, without its unused
``secrets`` import.

Same tower shape as the reference (fields/fq2.go, fq6.go, fq12.go):

  * Fq2  = Fq[u] / (u^2 - beta),   beta = non_residue          (pairs of ints)
  * Fq6  = Fq2[v] / (v^3 - xi),    xi   = non_residue (in Fq2) (3-tuples of Fq2)
  * Fq12 = Fq6[w] / (w^2 - v)                                  (2-tuples of Fq6)

Element encodings are immutable tuples so values can be hashed/compared and
shared freely.  Multiplication uses Karatsuba (Fq2/Fq12), Toom-style
interpolation (Fq6) and complex squaring — the standard formulas from
"Multiplication and Squaring on Pairing-Friendly Fields" and eprint 2010/354,
which are also what the reference implements (fq2.go:63-133, fq6.go:65-173,
fq12.go:72-137), so all values match the reference bit-for-bit.

``Fq12.exp`` here is a plain square-and-multiply like the reference's
(fq12.go:139-156, the author-flagged bottleneck); the *fast* final
exponentiation lives in :mod:`go_snark_study_tpu_torch.bn128.pairing` and is
cross-checked against this naive path in the tests.
"""

from __future__ import annotations

from typing import Tuple

from .fq import Fq

__all__ = ["Fq2", "Fq6", "Fq12"]

Fq2Elem = Tuple[int, int]
Fq6Elem = Tuple[Fq2Elem, Fq2Elem, Fq2Elem]
Fq12Elem = Tuple[Fq6Elem, Fq6Elem]


class Fq2:
    """Quadratic extension.  Reference: fields/fq2.go:9-154."""

    __slots__ = ("F", "non_residue")

    def __init__(self, f: Fq, non_residue: int):
        self.F = f
        self.non_residue = non_residue

    def zero(self) -> Fq2Elem:
        return (0, 0)

    def one(self) -> Fq2Elem:
        return (1, 0)

    def mul_by_non_residue(self, a: int) -> int:
        return self.F.mul(self.non_residue, a)

    def add(self, a: Fq2Elem, b: Fq2Elem) -> Fq2Elem:
        F = self.F
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def double(self, a: Fq2Elem) -> Fq2Elem:
        return self.add(a, a)

    def sub(self, a: Fq2Elem, b: Fq2Elem) -> Fq2Elem:
        F = self.F
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def neg(self, a: Fq2Elem) -> Fq2Elem:
        return self.sub(self.zero(), a)

    def mul(self, a: Fq2Elem, b: Fq2Elem) -> Fq2Elem:
        # Karatsuba: (a0 + a1 u)(b0 + b1 u) with u^2 = beta
        F = self.F
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        return (
            F.add(v0, self.mul_by_non_residue(v1)),
            F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])), F.add(v0, v1)),
        )

    def mul_scalar(self, p: Fq2Elem, e: int) -> Fq2Elem:
        # double-and-add over the integers (reference fq2.go:78-96); for a
        # field this equals componentwise multiplication by e mod q.
        F = self.F
        return (F.mul(p[0], e), F.mul(p[1], e))

    def inverse(self, a: Fq2Elem) -> Fq2Elem:
        # eprint 2010/354 algorithm 8
        F = self.F
        t0 = F.square(a[0])
        t1 = F.square(a[1])
        t2 = F.sub(t0, self.mul_by_non_residue(t1))
        t3 = F.inverse(t2)
        return (F.mul(a[0], t3), F.neg(F.mul(a[1], t3)))

    def div(self, a: Fq2Elem, b: Fq2Elem) -> Fq2Elem:
        return self.mul(a, self.inverse(b))

    def square(self, a: Fq2Elem) -> Fq2Elem:
        # complex squaring
        F = self.F
        ab = F.mul(a[0], a[1])
        return (
            F.sub(
                F.mul(F.add(a[0], a[1]), F.add(a[0], self.mul_by_non_residue(a[1]))),
                F.add(ab, self.mul_by_non_residue(ab)),
            ),
            F.add(ab, ab),
        )

    def exp(self, base: Fq2Elem, e: int) -> Fq2Elem:
        res = self.one()
        acc = base
        while e:
            if e & 1:
                res = self.mul(res, acc)
            acc = self.square(acc)
            e >>= 1
        return res

    def is_zero(self, a: Fq2Elem) -> bool:
        return self.F.is_zero(a[0]) and self.F.is_zero(a[1])

    def affine(self, a: Fq2Elem) -> Fq2Elem:
        F = self.F
        return (F.affine(a[0]), F.affine(a[1]))

    def equal(self, a: Fq2Elem, b: Fq2Elem) -> bool:
        F = self.F
        return F.equal(a[0], b[0]) and F.equal(a[1], b[1])

    def copy(self, a: Fq2Elem) -> Fq2Elem:
        return a

    def rand(self) -> Fq2Elem:
        return (self.F.rand(), self.F.rand())


class Fq6:
    """Cubic-over-quadratic extension.  Reference: fields/fq6.go:9-192."""

    __slots__ = ("F", "non_residue")

    def __init__(self, f: Fq2, non_residue: Fq2Elem):
        self.F = f
        self.non_residue = non_residue

    def zero(self) -> Fq6Elem:
        z = self.F.zero()
        return (z, z, z)

    def one(self) -> Fq6Elem:
        z = self.F.zero()
        return (self.F.one(), z, z)

    def mul_by_non_residue(self, a: Fq2Elem) -> Fq2Elem:
        return self.F.mul(self.non_residue, a)

    def add(self, a: Fq6Elem, b: Fq6Elem) -> Fq6Elem:
        F = self.F
        return (F.add(a[0], b[0]), F.add(a[1], b[1]), F.add(a[2], b[2]))

    def double(self, a: Fq6Elem) -> Fq6Elem:
        return self.add(a, a)

    def sub(self, a: Fq6Elem, b: Fq6Elem) -> Fq6Elem:
        F = self.F
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]), F.sub(a[2], b[2]))

    def neg(self, a: Fq6Elem) -> Fq6Elem:
        return self.sub(self.zero(), a)

    def mul(self, a: Fq6Elem, b: Fq6Elem) -> Fq6Elem:
        # interpolation-style 6-multiplication (Devegili et al. section 4)
        F = self.F
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        v2 = F.mul(a[2], b[2])
        c0 = F.add(
            v0,
            self.mul_by_non_residue(
                F.sub(F.mul(F.add(a[1], a[2]), F.add(b[1], b[2])), F.add(v1, v2))
            ),
        )
        c1 = F.add(
            F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])), F.add(v0, v1)),
            self.mul_by_non_residue(v2),
        )
        c2 = F.add(
            F.sub(F.mul(F.add(a[0], a[2]), F.add(b[0], b[2])), F.add(v0, v2)),
            v1,
        )
        return (c0, c1, c2)

    def mul_scalar(self, base: Fq6Elem, e: int) -> Fq6Elem:
        F = self.F
        return tuple(F.mul_scalar(c, e) for c in base)  # type: ignore[return-value]

    def inverse(self, a: Fq6Elem) -> Fq6Elem:
        F = self.F
        t0 = F.square(a[0])
        t1 = F.square(a[1])
        t2 = F.square(a[2])
        t3 = F.mul(a[0], a[1])
        t4 = F.mul(a[0], a[2])
        t5 = F.mul(a[1], a[2])
        c0 = F.sub(t0, self.mul_by_non_residue(t5))
        c1 = F.sub(self.mul_by_non_residue(t2), t3)
        c2 = F.sub(t1, t4)
        t6 = F.inverse(
            F.add(
                F.mul(a[0], c0),
                self.mul_by_non_residue(F.add(F.mul(a[2], c1), F.mul(a[1], c2))),
            )
        )
        return (F.mul(t6, c0), F.mul(t6, c1), F.mul(t6, c2))

    def div(self, a: Fq6Elem, b: Fq6Elem) -> Fq6Elem:
        return self.mul(a, self.inverse(b))

    def square(self, a: Fq6Elem) -> Fq6Elem:
        # CH-SQR2 squaring
        F = self.F
        s0 = F.square(a[0])
        ab = F.mul(a[0], a[1])
        s1 = F.add(ab, ab)
        s2 = F.square(F.add(F.sub(a[0], a[1]), a[2]))
        bc = F.mul(a[1], a[2])
        s3 = F.add(bc, bc)
        s4 = F.square(a[2])
        return (
            F.add(s0, self.mul_by_non_residue(s3)),
            F.add(s1, self.mul_by_non_residue(s4)),
            F.sub(F.add(F.add(s1, s2), s3), F.add(s0, s4)),
        )

    def is_zero(self, a: Fq6Elem) -> bool:
        return all(self.F.is_zero(c) for c in a)

    def affine(self, a: Fq6Elem) -> Fq6Elem:
        F = self.F
        return (F.affine(a[0]), F.affine(a[1]), F.affine(a[2]))

    def equal(self, a: Fq6Elem, b: Fq6Elem) -> bool:
        F = self.F
        return F.equal(a[0], b[0]) and F.equal(a[1], b[1]) and F.equal(a[2], b[2])

    def copy(self, a: Fq6Elem) -> Fq6Elem:
        return a

    def rand(self) -> Fq6Elem:
        return (self.F.rand(), self.F.rand(), self.F.rand())


class Fq12:
    """Quadratic-over-cubic-over-quadratic extension.
    Reference: fields/fq12.go:11-165."""

    __slots__ = ("F", "fq2", "non_residue")

    def __init__(self, f: Fq6, fq2: Fq2, non_residue: Fq2Elem):
        self.F = f
        self.fq2 = fq2
        self.non_residue = non_residue

    def zero(self) -> Fq12Elem:
        z = self.F.zero()
        return (z, z)

    def one(self) -> Fq12Elem:
        return (self.F.one(), self.F.zero())

    def mul_by_non_residue(self, a: Fq6Elem) -> Fq6Elem:
        # multiply by w (the Fq12 generator): rotates Fq6 coefficients and
        # scales the wrapped one by xi.
        return (self.fq2.mul(self.non_residue, a[2]), a[0], a[1])

    def add(self, a: Fq12Elem, b: Fq12Elem) -> Fq12Elem:
        F = self.F
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def double(self, a: Fq12Elem) -> Fq12Elem:
        return self.add(a, a)

    def sub(self, a: Fq12Elem, b: Fq12Elem) -> Fq12Elem:
        F = self.F
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def neg(self, a: Fq12Elem) -> Fq12Elem:
        return self.sub(self.zero(), a)

    def conjugate(self, a: Fq12Elem) -> Fq12Elem:
        """a0 - a1 w; the Frobenius^6 map, used by the fast final exp."""
        return (a[0], self.F.neg(a[1]))

    def mul(self, a: Fq12Elem, b: Fq12Elem) -> Fq12Elem:
        F = self.F
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        return (
            F.add(v0, self.mul_by_non_residue(v1)),
            F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])), F.add(v0, v1)),
        )

    def mul_scalar(self, base: Fq12Elem, e: int) -> Fq12Elem:
        F = self.F
        return (F.mul_scalar(base[0], e), F.mul_scalar(base[1], e))

    def inverse(self, a: Fq12Elem) -> Fq12Elem:
        F = self.F
        t0 = F.square(a[0])
        t1 = F.square(a[1])
        t2 = F.sub(t0, self.mul_by_non_residue(t1))
        t3 = F.inverse(t2)
        return (F.mul(a[0], t3), F.neg(F.mul(a[1], t3)))

    def div(self, a: Fq12Elem, b: Fq12Elem) -> Fq12Elem:
        return self.mul(a, self.inverse(b))

    def square(self, a: Fq12Elem) -> Fq12Elem:
        F = self.F
        ab = F.mul(a[0], a[1])
        return (
            F.sub(
                F.mul(F.add(a[0], a[1]), F.add(a[0], self.mul_by_non_residue(a[1]))),
                F.add(ab, self.mul_by_non_residue(ab)),
            ),
            F.add(ab, ab),
        )

    def exp(self, base: Fq12Elem, e: int) -> Fq12Elem:
        """Plain square-and-multiply — the semantics (and the bottleneck) of
        the reference's Fq12.Exp (fq12.go:139-156).  The pairing module's fast
        final exponentiation must agree with this on the final-exp exponent."""
        res = self.one()
        acc = base
        while e:
            if e & 1:
                res = self.mul(res, acc)
            acc = self.square(acc)
            e >>= 1
        return res

    def is_zero(self, a: Fq12Elem) -> bool:
        return self.F.is_zero(a[0]) and self.F.is_zero(a[1])

    def affine(self, a: Fq12Elem) -> Fq12Elem:
        F = self.F
        return (F.affine(a[0]), F.affine(a[1]))

    def equal(self, a: Fq12Elem, b: Fq12Elem) -> bool:
        F = self.F
        return F.equal(a[0], b[0]) and F.equal(a[1], b[1])

    def copy(self, a: Fq12Elem) -> Fq12Elem:
        return a

    def rand(self) -> Fq12Elem:
        return (self.F.rand(), self.F.rand())
