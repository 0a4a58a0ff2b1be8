"""Point validation at the wire boundary.

Copy of ``go_snark_study_tpu/utils/validate.py``.

The reference deserializers (utils/base10parsers.go, utils/hexparsers.go)
build raw big.Int tuples and the verifiers pair whatever they are given —
an off-curve or wrong-subgroup "point" smuggled into a proof or verifying
key silently produces garbage pairings.  Like the ``Fq.Rand`` bias fix
(fields/fq.py), this is a deliberate, documented divergence: every
Jacobian point parsed from JSON is checked on-curve, and the
small-cardinality G2 artifacts (proof πB, vk/pk G2 scalars) additionally
get a subgroup check (G1 has cofactor 1 on BN128, so on-curve implies the
subgroup there; bulk G2 arrays get on-curve only — the pairing-relevant
wire points are the small ones).

Disable with GOSNARK_VALIDATE=0 (e.g. for ingesting the reference's own
fixtures plus adversarial-fixture tests).
"""

from __future__ import annotations

import os

from ..bn128.constants import Q, R

__all__ = [
    "enabled",
    "check_g1",
    "check_g2",
    "check_g2_subgroup",
    "PointValidationError",
]


class PointValidationError(ValueError):
    pass


def enabled() -> bool:
    return os.environ.get("GOSNARK_VALIDATE", "1") != "0"


def check_g1(p, what: str = "G1 point"):
    """Jacobian on-curve check for E(Fq): y^2 = x^3 + 3 — in Jacobian
    coordinates Y^2 = X^3 + 3 Z^6.  Identity (Z = 0) passes.  Returns p."""
    if not enabled():
        return p
    x, y, z = (int(p[0]) % Q, int(p[1]) % Q, int(p[2]) % Q)
    if z == 0:
        return p
    z2 = z * z % Q
    z6 = z2 * z2 % Q * z2 % Q
    if y * y % Q != (x * x % Q * x + 3 * z6) % Q:
        raise PointValidationError(f"{what}: not on the BN128 curve")
    return p


def _fq2(a):
    return (int(a[0]) % Q, int(a[1]) % Q)


def _fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    v0 = a[0] * b[0] % Q
    v1 = a[1] * b[1] % Q
    t = (a[0] + a[1]) * (b[0] + b[1]) % Q
    return ((v0 - v1) % Q, (t - v0 - v1) % Q)


def _fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def _twist_coef_b():
    # b' = 3 / (9 + u), cached
    global _TWIST_B
    try:
        return _TWIST_B
    except NameError:
        pass
    # (9 + u)^-1 = (9 - u) / (81 + 1)
    norm_inv = pow(82, -1, Q)
    inv = (9 * norm_inv % Q, (-norm_inv) % Q)
    _TWIST_B = _fq2_mul((3, 0), inv)
    return _TWIST_B


def check_g2(p, what: str = "G2 point"):
    """Jacobian on-curve check for the twist E'(Fq2):
    Y^2 = X^3 + b' Z^6 with b' = 3/(9+u).  Identity passes.  Returns p."""
    if not enabled():
        return p
    x, y, z = (_fq2(p[0]), _fq2(p[1]), _fq2(p[2]))
    if z == (0, 0):
        return p
    z2 = _fq2_mul(z, z)
    z6 = _fq2_mul(_fq2_mul(z2, z2), z2)
    lhs = _fq2_mul(y, y)
    rhs = _fq2_add(_fq2_mul(_fq2_mul(x, x), x), _fq2_mul(_twist_coef_b(), z6))
    if lhs != rhs:
        raise PointValidationError(f"{what}: not on the BN128 twist")
    return p


def check_g2_subgroup(p, what: str = "G2 point"):
    """Full subgroup check r·P == O (the twist has a nontrivial cofactor,
    so on-curve alone does not pin the r-torsion).  Host double-and-add —
    ~1 ms; only applied to the handful of pairing-relevant wire points.
    Implies/includes the on-curve check.  Returns p."""
    if not enabled():
        return p
    check_g2(p, what)
    from ..bn128 import default_bn128

    g2 = default_bn128().g2
    if not g2.is_zero(g2.mul_scalar(p, R)):
        raise PointValidationError(f"{what}: not in the r-torsion subgroup")
    return p
