"""Prime-field arithmetic over arbitrary moduli (host / exact path).

Copy of ``go_snark_study_tpu/fields/fq.py``, unchanged, so that the port
imports nothing of the JAX package.

Host field layer.  This is the exact-integer oracle
layer: Python's arbitrary-precision ints play the role the reference's
``math/big`` does (reference: fields/fq.go:15-165).  The batched device limb
kernels in :mod:`go_snark_study_tpu_torch.ops` are verified bit-exactly against this
layer.

Design notes (vs the reference):
  * ``affine`` reduces to the canonical residue in ``[0, q)``; the reference's
    branchy implementation (fq.go:142-159) computes the same value.
  * ``rand`` samples uniformly below q (rejection sampling).  The reference's
    ``Fq.Rand`` (fq.go:116-128) samples ``(bitlen/8)-1`` random *bytes* and is
    therefore biased and never covers the full range — a security-relevant
    defect we deliberately do not reproduce.  ``rand_reference_biased``
    reproduces the reference distribution for anyone who needs it.
"""

from __future__ import annotations

import secrets

__all__ = ["Fq"]


class Fq:
    """The field Z/q.  Elements are plain Python ints (any representative;
    operations reduce mod q).  Mirrors the API surface of the reference's
    ``fields.Fq`` (fields/fq.go:10-20)."""

    __slots__ = ("q",)

    def __init__(self, q: int):
        self.q = q

    # -- constants ---------------------------------------------------------
    def zero(self) -> int:
        return 0

    def one(self) -> int:
        return 1

    # -- arithmetic --------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.q

    def double(self, a: int) -> int:
        return (a + a) % self.q

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.q

    def neg(self, a: int) -> int:
        return (-a) % self.q

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.q

    def mul_scalar(self, base: int, e: int) -> int:
        return self.mul(base, e)

    def inverse(self, a: int) -> int:
        # python 3.8+: pow with -1 exponent does modular inverse (extended gcd)
        return pow(a, -1, self.q)

    def div(self, a: int, b: int) -> int:
        return (a * self.inverse(b)) % self.q

    def square(self, a: int) -> int:
        return (a * a) % self.q

    def exp(self, base: int, e: int) -> int:
        return pow(base % self.q, e, self.q)

    # -- predicates / canonicalization ------------------------------------
    def is_zero(self, a: int) -> bool:
        return a % self.q == 0

    def affine(self, a: int) -> int:
        """Canonical residue in [0, q).  Reference: fields/fq.go:142-159."""
        return a % self.q

    def equal(self, a: int, b: int) -> bool:
        return (a - b) % self.q == 0

    def copy(self, a: int) -> int:
        return a

    # -- randomness --------------------------------------------------------
    def rand(self) -> int:
        """Uniform element of [0, q) (fixes the reference's biased sampler)."""
        nbits = self.q.bit_length()
        while True:
            r = secrets.randbits(nbits)
            if r < self.q:
                return r

    def rand_reference_biased(self) -> int:
        """The reference's distribution (fields/fq.go:116-128): reads
        ``(bitlen//8)-1`` random bytes, i.e. at most ``q.bit_length()-8`` bits.
        Kept only for behavioural comparison; do not use for security."""
        nbytes = (self.q.bit_length() // 8) - 1
        return int.from_bytes(secrets.token_bytes(nbytes), "big") % self.q
