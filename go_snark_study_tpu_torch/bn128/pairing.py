"""Optimal-ate pairing over BN128 (host path).

Copy of ``go_snark_study_tpu/bn128/pairing.py``, unchanged; the port's
verifier runs on it.

Verification is O(1) and latency-bound, so it stays on host (SURVEY §2.9) —
but unlike the reference we do NOT pay the naive 2790-bit square-and-multiply
final exponentiation (the author-flagged bottleneck, fields/fq12.go:139-156 +
bn128/bn128.go:418-421).  ``final_exponentiation`` uses the standard
easy-part/hard-part decomposition with Frobenius maps and a 4-way Shamir
multi-exponentiation; ``final_exponentiation_naive`` reproduces the
reference's method and the tests assert both agree, so results are bit-exact
with the reference.

Pipeline (reference: bn128/bn128.go:179-416):
    pairing = precompute_g1 -> precompute_g2 (line coefficients) ->
              miller_loop (sparse mul_by_024 line multiplications) ->
              final_exponentiation
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

from ..fields import Fq, Fq2, Fq6, Fq12
from . import constants as C
from .curve import GroupG1, GroupG2

__all__ = ["Bn128", "default_bn128"]


class EllCoeffs(NamedTuple):
    """One line-function evaluation step (reference bn128.go:203-207)."""

    ell_0: Tuple[int, int]
    ell_vw: Tuple[int, int]
    ell_vv: Tuple[int, int]


class G2Precomp(NamedTuple):
    qx: Tuple[int, int]
    qy: Tuple[int, int]
    coeffs: List[EllCoeffs]


class Bn128:
    """BN128 context: field tower, groups, pairing.  Mirrors the surface of the
    reference's ``Bn128`` struct (bn128/bn128.go:11-35) with derived (not
    hard-coded) pairing constants; tests pin them to the reference values."""

    def __init__(self):
        self.q = C.Q
        self.r = C.R
        self.fq1 = Fq(C.Q)
        self.non_residue_fq2 = C.NON_RESIDUE_FQ2
        self.non_residue_fq6 = C.NON_RESIDUE_FQ6
        self.fq2 = Fq2(self.fq1, self.non_residue_fq2)
        self.fq6 = Fq6(self.fq2, self.non_residue_fq6)
        self.fq12 = Fq12(self.fq6, self.fq2, self.non_residue_fq6)
        self.g1 = GroupG1(self.fq1, C.G1_GENERATOR)
        self.g2 = GroupG2(self.fq2, C.G2_GENERATOR)

        self.loop_count = C.LOOP_COUNT
        self.loop_count_neg = C.LOOP_COUNT_NEG
        self.final_exp = C.FINAL_EXP

        # pairing constants (reference bn128.go:124-167, here derived)
        self.two_inv = self.fq1.inverse(2)
        self.coef_b = 3
        self.twist = C.NON_RESIDUE_FQ6  # xi = 9 + u
        self.twist_coef_b = self.fq2.mul_scalar(self.fq2.inverse(self.twist), self.coef_b)
        # Frobenius on Fq2: conj; for a = a0 + a1 u, a^q = a0 - a1 u,
        # i.e. the imaginary part is scaled by  u^(q-1) = (u^2)^((q-1)/2)
        # = beta^((q-1)/2) = -1  (bn128.go:138's FrobeniusCoeffsC11).
        self.frobenius_coeffs_c11 = C.Q - 1
        # untwist-Frobenius-twist coefficients: x -> conj(x) * xi^((q-1)/3),
        # y -> conj(y) * xi^((q-1)/2)  (bn128.go:143-167's TwistMulByQX/QY).
        self.twist_mul_by_qx = self.fq2.exp(self.twist, (C.Q - 1) // 3)
        self.twist_mul_by_qy = self.fq2.exp(self.twist, (C.Q - 1) // 2)

        # Frobenius coefficients for Fq12: gamma_k = xi^(k (q-1)/6), k = 1..5.
        g = self.fq2.exp(self.twist, (C.Q - 1) // 6)
        gammas = [self.fq2.one(), g]
        for _ in range(4):
            gammas.append(self.fq2.mul(gammas[-1], g))
        self._frob_gammas = gammas  # gamma^0 .. gamma^5

        # hard part of the final exponent, decomposed in base q:
        # (q^4 - q^2 + 1)/r = e0 + e1 q + e2 q^2 + e3 q^3.
        hard = (C.Q**4 - C.Q**2 + 1) // C.R
        digits = []
        h = hard
        for _ in range(4):
            digits.append(h % C.Q)
            h //= C.Q
        assert h == 0
        self._hard_digits = digits

    # ------------------------------------------------------------------
    # Frobenius endomorphism on Fq12 (for the fast final exponentiation)
    # ------------------------------------------------------------------
    def _fq12_frobenius(self, a):
        """x -> x^q.  Write a = sum_{k=0..5} b_k w^k (b_k in Fq2); then
        a^q = sum conj(b_k) gamma^k w^k with gamma = xi^((q-1)/6)."""
        fq1 = self.fq1
        (c0, c1) = a
        # b_0, b_2, b_4 = c0 coefficients; b_1, b_3, b_5 = c1 coefficients
        bs = [c0[0], c1[0], c0[1], c1[1], c0[2], c1[2]]
        out = []
        for k, b in enumerate(bs):
            conj = (b[0], fq1.neg(b[1]))
            out.append(self.fq2.mul(conj, self._frob_gammas[k]))
        return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))

    def fq12_frobenius(self, a, power: int = 1):
        for _ in range(power % 12):
            a = self._fq12_frobenius(a)
        return a

    # ------------------------------------------------------------------
    # pairing pipeline
    # ------------------------------------------------------------------
    def precompute_g1(self, p):
        px, py = self.g1.affine(p)
        return (px, py)

    def precompute_g2(self, p) -> G2Precomp:
        """Line-coefficient precomputation (reference bn128.go:213-260):
        one doubling step per Miller bit, a mixed addition per set bit, and
        the two Frobenius-twisted additions at the end."""
        fq2 = self.fq2
        q_aff = self.g2.affine(p)
        qx, qy = q_aff[0], q_aff[1]
        coeffs: List[EllCoeffs] = []
        r = (qx, qy, fq2.one())

        for i in range(self.loop_count.bit_length() - 2, -1, -1):
            c, r = self._doubling_step(r)
            coeffs.append(c)
            if (self.loop_count >> i) & 1:
                c, r = self._mixed_addition_step((qx, qy), r)
                coeffs.append(c)

        q1 = self.g2.affine(self._g2_mul_by_q((qx, qy, fq2.one())))
        if not fq2.equal(q1[2], fq2.one()):
            raise ArithmeticError("g2 Frobenius image not affine")
        q2 = self.g2.affine(self._g2_mul_by_q(q1))
        if not fq2.equal(q2[2], fq2.one()):
            raise ArithmeticError("g2 double-Frobenius image not affine")

        if self.loop_count_neg:
            r = (r[0], fq2.neg(r[1]), r[2])
        q2y_neg = fq2.neg(q2[1])

        c, r = self._mixed_addition_step((q1[0], q1[1]), r)
        coeffs.append(c)
        c, r = self._mixed_addition_step((q2[0], q2y_neg), r)
        coeffs.append(c)
        return G2Precomp(qx, qy, coeffs)

    def _doubling_step(self, cur):
        """Projective doubling with line evaluation (bn128.go:262-291)."""
        fq2 = self.fq2
        x, y, z = cur
        a = fq2.mul_scalar(fq2.mul(x, y), self.two_inv)
        b = fq2.square(y)
        c = fq2.square(z)
        d = fq2.add(c, fq2.add(c, c))
        e = fq2.mul(self.twist_coef_b, d)
        f = fq2.add(e, fq2.add(e, e))
        g = fq2.mul_scalar(fq2.add(b, f), self.two_inv)
        h = fq2.sub(fq2.square(fq2.add(y, z)), fq2.add(b, c))
        i = fq2.sub(e, b)
        j = fq2.square(x)
        e_sq = fq2.square(e)
        nx = fq2.mul(a, fq2.sub(b, f))
        ny = fq2.sub(fq2.sub(fq2.square(g), e_sq), fq2.add(e_sq, e_sq))
        nz = fq2.mul(b, h)
        coeffs = EllCoeffs(
            ell_0=fq2.mul(i, self.twist),
            ell_vw=fq2.neg(h),
            ell_vv=fq2.add(j, fq2.add(j, j)),
        )
        return coeffs, (nx, ny, nz)

    def _mixed_addition_step(self, base_affine, cur):
        """Mixed addition with line evaluation (bn128.go:293-326)."""
        fq2 = self.fq2
        x1, y1, z1 = cur
        x2, y2 = base_affine
        d = fq2.sub(x1, fq2.mul(x2, z1))
        e = fq2.sub(y1, fq2.mul(y2, z1))
        f = fq2.square(d)
        g = fq2.square(e)
        h = fq2.mul(d, f)
        i = fq2.mul(x1, f)
        j = fq2.sub(fq2.add(h, fq2.mul(z1, g)), fq2.add(i, i))
        nx = fq2.mul(d, j)
        ny = fq2.sub(fq2.mul(e, fq2.sub(i, j)), fq2.mul(h, y1))
        nz = fq2.mul(z1, h)
        coeffs = EllCoeffs(
            ell_0=fq2.mul(self.twist, fq2.sub(fq2.mul(e, x2), fq2.mul(d, y2))),
            ell_vw=d,
            ell_vv=fq2.neg(e),
        )
        return coeffs, (nx, ny, nz)

    def _g2_mul_by_q(self, p):
        """Untwist-Frobenius-twist endomorphism on G2 (bn128.go:327-346)."""
        fq1, fq2 = self.fq1, self.fq2
        conj = lambda a: (a[0], fq1.mul(a[1], self.frobenius_coeffs_c11))
        return (
            fq2.mul(self.twist_mul_by_qx, conj(p[0])),
            fq2.mul(self.twist_mul_by_qy, conj(p[1])),
            conj(p[2]),
        )

    def mul_by_024(self, a, ell_0, ell_vw, ell_vv):
        """Sparse Fq12 multiplication by a line value with nonzero
        coefficients at w^0, w^2, w^4 only (bn128.go:402-416 — the reference
        uses a full-shape mul; this exploits the sparsity: 15 Fq2 muls vs
        the dense mul's 18, bit-identical result, asserted against the dense
        form in the test suite).

        Layout: b = (b0, b1) over Fq6 with b0 = (x0, 0, x2), b1 = (0, y1, 0)
        where x0 = ell_0, y1 = ell_vw, x2 = ell_vv.  Karatsuba over Fq6:
        c0 = a0·b0 + γ·(a1·b1), c1 = (a0+a1)(b0+b1) − a0·b0 − a1·b1 with the
        sparse products expanded component-wise (v³ = ξ)."""
        fq2, fq6 = self.fq2, self.fq6
        a0, a1 = a
        x0, y1, x2 = ell_0, ell_vw, ell_vv
        xi = fq6.mul_by_non_residue  # Fq2 -> Fq2, multiply by ξ = 9 + u

        # t0 = a0 · (x0, 0, x2): 6 Fq2 muls
        t0 = (
            fq2.add(fq2.mul(a0[0], x0), xi(fq2.mul(a0[1], x2))),
            fq2.add(fq2.mul(a0[1], x0), xi(fq2.mul(a0[2], x2))),
            fq2.add(fq2.mul(a0[2], x0), fq2.mul(a0[0], x2)),
        )
        # t1 = a1 · (0, y1, 0): 3 Fq2 muls
        t1 = (
            xi(fq2.mul(a1[2], y1)),
            fq2.mul(a1[0], y1),
            fq2.mul(a1[1], y1),
        )
        # c0 = t0 + γ·t1 where γ = w² = v: (B0,B1,B2) -> (ξB2, B0, B1)
        c0 = (
            fq2.add(t0[0], xi(t1[2])),
            fq2.add(t0[1], t1[0]),
            fq2.add(t0[2], t1[1]),
        )
        # c1 = (a0+a1)·(x0, y1, x2) − t0 − t1: one dense Fq6 mul (6 muls)
        s = fq6.mul(fq6.add(a0, a1), (x0, y1, x2))
        c1 = fq6.sub(fq6.sub(s, t0), t1)
        return (c0, c1)

    def miller_loop(self, pre1, pre2: G2Precomp):
        """Reference: bn128.go:348-400."""
        px, py = pre1
        fq2, fq12 = self.fq2, self.fq12
        f = fq12.one()
        idx = 0
        for i in range(self.loop_count.bit_length() - 2, -1, -1):
            c = pre2.coeffs[idx]
            idx += 1
            f = fq12.square(f)
            f = self.mul_by_024(
                f, c.ell_0, fq2.mul_scalar(c.ell_vw, py), fq2.mul_scalar(c.ell_vv, px)
            )
            if (self.loop_count >> i) & 1:
                c = pre2.coeffs[idx]
                idx += 1
                f = self.mul_by_024(
                    f, c.ell_0, fq2.mul_scalar(c.ell_vw, py), fq2.mul_scalar(c.ell_vv, px)
                )
        if self.loop_count_neg:
            f = fq12.inverse(f)
        for _ in range(2):
            c = pre2.coeffs[idx]
            idx += 1
            f = self.mul_by_024(
                f, c.ell_0, fq2.mul_scalar(c.ell_vw, py), fq2.mul_scalar(c.ell_vv, px)
            )
        return f

    # ------------------------------------------------------------------
    # final exponentiation
    # ------------------------------------------------------------------
    def final_exponentiation_naive(self, f):
        """The reference's method: one Fq12.Exp by the full 2790-bit
        (q^12-1)/r (bn128.go:418-421).  Exact oracle for the fast path."""
        return self.fq12.exp(f, self.final_exp)

    def final_exponentiation(self, f):
        """Easy part (q^6-1)(q^2+1) via conjugate/inverse/Frobenius, then the
        hard part (q^4-q^2+1)/r as a base-q 4-digit Shamir multi-exponentiation
        over Frobenius images.  Always equals ``final_exponentiation_naive``."""
        fq12 = self.fq12
        # easy part: f <- f^(q^6-1) = conj(f) * f^-1 ; then f <- f^(q^2+1)
        t = fq12.mul(fq12.conjugate(f), fq12.inverse(f))
        t = fq12.mul(self.fq12_frobenius(t, 2), t)
        # hard part: t^(e0 + e1 q + e2 q^2 + e3 q^3)
        bases = [t]
        for k in range(1, 4):
            bases.append(self.fq12_frobenius(t, k))
        return self._multi_exp(bases, self._hard_digits)

    def _multi_exp(self, bases, exps):
        """Shamir's trick: shared-squaring 4-way multi-exponentiation."""
        fq12 = self.fq12
        n = len(bases)
        # precompute subset products: table[mask] = prod_{i in mask} bases[i]
        table = [fq12.one()] * (1 << n)
        for mask in range(1, 1 << n):
            low = mask & -mask
            i = low.bit_length() - 1
            table[mask] = fq12.mul(table[mask ^ low], bases[i])
        nbits = max(e.bit_length() for e in exps)
        acc = fq12.one()
        for bit in range(nbits - 1, -1, -1):
            acc = fq12.square(acc)
            mask = 0
            for i, e in enumerate(exps):
                if (e >> bit) & 1:
                    mask |= 1 << i
            if mask:
                acc = fq12.mul(acc, table[mask])
        return acc

    # ------------------------------------------------------------------
    def pairing(self, p1, p2):
        """e(p1, p2) for p1 in G1 (Jacobian int triple) and p2 in G2
        (Jacobian Fq2 triple).  Reference: bn128.go:179-186."""
        pre1 = self.precompute_g1(p1)
        pre2 = self.precompute_g2(p2)
        f = self.miller_loop(pre1, pre2)
        return self.final_exponentiation(f)


_DEFAULT: Bn128 | None = None


def default_bn128() -> Bn128:
    """Shared context (constructing one is cheap but not free)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Bn128()
    return _DEFAULT
