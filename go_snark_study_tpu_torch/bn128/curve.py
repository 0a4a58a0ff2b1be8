"""BN128 group arithmetic on host ints (exact path).

Copy of ``go_snark_study_tpu/bn128/curve.py``, unchanged.  The port uses it
to build the fixed-base tables and to combine MSM window sums.

G1 = E(Fq): y^2 = x^3 + 3, G2 = E'(Fq2) on the twist y^2 = x^3 + 3/xi.
Points are Jacobian triples; G1 points are ``(x, y, z)`` ints, G2 points are
``((x0,x1), (y0,y1), (z0,z1))`` Fq2 tuples — the same shapes the reference
serialises ([3] / [3][2], bn128/g1.go:9-12, g2.go:9-12), so artifacts are
wire-compatible.

Formulas: add-2007-bl addition and dbl-2009-l doubling (the same EFD formulas
the reference uses, g1.go:32-138, g2.go:32-140) so that Jacobian coordinates —
not just the affine points — match the reference bit-for-bit, which is what
makes serialized Pk/Vk/Proof artifacts comparable.

The batched device versions of these formulas live in
:mod:`go_snark_study_tpu_torch.ops.curve_ops`; they are tested against this module.
"""

from __future__ import annotations

from .. import native
from ..fields import Fq, Fq2

__all__ = ["GroupG1", "GroupG2"]


class _JacobianGroup:
    """Shared Jacobian-coordinate group law over any of our field objects.

    ``F`` must expose zero/one/add/sub/mul/square/double/inverse/is_zero/
    equal/affine — satisfied by both Fq and Fq2, which is exactly how the
    reference shares its G1/G2 code shape (g1.go vs g2.go)."""

    def __init__(self, F, generator_affine):
        self.F = F
        self.g = (generator_affine[0], generator_affine[1], F.one())

    def zero(self):
        raise NotImplementedError

    def is_zero(self, p) -> bool:
        return self.F.is_zero(p[2])

    def add(self, p1, p2):
        F = self.F
        if self.is_zero(p1):
            return p2
        if self.is_zero(p2):
            return p1

        x1, y1, z1 = p1
        x2, y2, z2 = p2
        z1z1 = F.square(z1)
        z2z2 = F.square(z2)
        u1 = F.mul(x1, z2z2)
        u2 = F.mul(x2, z1z1)
        s1 = F.mul(y1, F.mul(z2, z2z2))
        s2 = F.mul(y2, F.mul(z1, z1z1))
        h = F.sub(u2, u1)
        # complete group law: the reference's Add silently returns garbage
        # for p1 == +-p2 (add-2007-bl degenerates at h == 0; unreachable in
        # the reference's serial double-and-add but reachable in batch/table
        # construction) — route to double / identity instead.
        if F.is_zero(h):
            if F.is_zero(F.sub(s2, s1)):
                return self.double(p1)
            return self.zero()
        i = F.square(F.add(h, h))
        j = F.mul(h, i)
        r = F.double(F.sub(s2, s1))
        v = F.mul(u1, i)
        x3 = F.sub(F.sub(F.square(r), j), F.double(v))
        y3 = F.sub(F.mul(r, F.sub(v, x3)), F.double(F.mul(s1, j)))
        z3 = F.mul(F.sub(F.sub(F.square(F.add(z1, z2)), z1z1), z2z2), h)
        return (x3, y3, z3)

    def neg(self, p):
        return (p[0], self.F.neg(p[1]), p[2])

    def sub(self, a, b):
        return self.add(a, self.neg(b))

    def double(self, p):
        F = self.F
        if self.is_zero(p):
            return p
        a = F.square(p[0])
        b = F.square(p[1])
        c = F.square(b)
        d = F.double(F.sub(F.sub(F.square(F.add(p[0], b)), a), c))
        e = F.add(F.add(a, a), a)
        f = F.square(e)
        x3 = F.sub(f, F.double(d))
        eight_c = F.double(F.double(F.double(c)))
        y3 = F.sub(F.mul(e, F.sub(d, x3)), eight_c)
        z3 = F.double(F.mul(p[1], p[2]))
        return (x3, y3, z3)

    def mul_scalar(self, p, e: int):
        """MSB-first double-and-add (reference g1.go:140-155).  The device MSM in
        ops/msm.py replaces loops of this with Pippenger bucket accumulation.
        The loop runs in C (``native.mul_scalar``, the same formulas on
        Montgomery limbs, the same triple); here where the C takes no such
        inputs."""
        q = native.mul_scalar(self.F, p, e)
        if q is not None:
            return q
        q = self.zero()
        if e == 0:
            return q
        for i in range(e.bit_length() - 1, -1, -1):
            q = self.double(q)
            if (e >> i) & 1:
                q = self.add(q, p)
        return q

    def equal(self, p1, p2) -> bool:
        F = self.F
        if self.is_zero(p1):
            return self.is_zero(p2)
        if self.is_zero(p2):
            return False
        z1z1 = F.square(p1[2])
        z2z2 = F.square(p2[2])
        u1 = F.mul(p1[0], z2z2)
        u2 = F.mul(p2[0], z1z1)
        s1 = F.mul(p1[1], F.mul(p2[2], z2z2))
        s2 = F.mul(p2[1], F.mul(p1[2], z1z1))
        return F.equal(u1, u2) and F.equal(s1, s2)


class GroupG1(_JacobianGroup):
    """G1 = E(Fq).  Reference: bn128/g1.go.

    Note the reference's quirk: ``G1.Zero()`` returns the *affine pair*
    (0, 0) while the identity used in computation is the Jacobian (0, 0, 0)
    (g1.go:26-28 vs snark.go:256); we use (0, 0, 0) throughout and
    ``affine`` returns (0, 0) for it, matching observable behavior."""

    def __init__(self, F: Fq, generator_affine):
        super().__init__(F, generator_affine)

    def zero(self):
        z = self.F.zero()
        return (z, z, z)

    def affine(self, p):
        F = self.F
        if self.is_zero(p):
            return (F.zero(), F.zero())
        zinv = F.inverse(p[2])
        zinv2 = F.square(zinv)
        x = F.affine(F.mul(p[0], zinv2))
        y = F.affine(F.mul(p[1], F.mul(zinv2, zinv)))
        return (x, y)


class GroupG2(_JacobianGroup):
    """G2 = E'(Fq2) (the sextic twist).  Reference: bn128/g2.go.

    ``zero`` is (0, 1, 0) and ``affine`` returns a normalised Jacobian
    triple with z = 1 (g2.go:25-27, 183-200)."""

    def __init__(self, F: Fq2, generator_affine):
        super().__init__(F, generator_affine)

    def zero(self):
        return (self.F.zero(), self.F.one(), self.F.zero())

    def affine(self, p):
        F = self.F
        if self.is_zero(p):
            return self.zero()
        zinv = F.inverse(p[2])
        zinv2 = F.square(zinv)
        x = F.affine(F.mul(p[0], zinv2))
        y = F.affine(F.mul(p[1], F.mul(zinv2, zinv)))
        return (x, y, F.one())
