"""Shared protocol context: curve + scalar field + polynomial field.

Copy of ``go_snark_study_tpu/models/context.py``.  The reference keeps a
package-global ``Utils`` singleton per protocol (snark.go:71-95,
groth16/groth16.go:67-91); one lazily-constructed context is shared and
passed explicitly.

``msm_g1`` / ``msm_g2`` are the multi-scalar-multiplication hooks and
``batch_g1`` / ``batch_g2`` the fixed-base commitment hooks of the parity
protocols: the host default reproduces the reference's serial loops
(snark.go:265-286), and :mod:`.accel` installs the card's engines as their
backends.  A backend returns None to decline (below its size threshold), and
then the host loop runs.
"""

from __future__ import annotations

import secrets
from typing import Callable, Optional, Sequence

from ..bn128 import Bn128, default_bn128
from ..fields import Fq
from ..r1csqap import PolynomialField

__all__ = ["ProtocolContext", "default_context", "set_msm_backend"]


class ProtocolContext:
    def __init__(self, bn: Optional[Bn128] = None):
        self.bn = bn or default_bn128()
        self.fqr = Fq(self.bn.r)
        self.pf = PolynomialField(self.fqr)
        # hooks; signature: (points, scalars) -> point.  None = host loop.
        self._msm_g1_backend: Optional[Callable] = None
        self._msm_g2_backend: Optional[Callable] = None
        # fixed-base batch hooks; signature: (scalars) -> [points]
        self._batch_g1_backend: Optional[Callable] = None
        self._batch_g2_backend: Optional[Callable] = None

    # -- randomness (seedable for deterministic parity tests) --------------
    def rand_fr(self, rng=None) -> int:
        if rng is not None:
            return rng.randrange(self.fqr.q)
        return self.fqr.rand()

    # -- multi-scalar multiplication ---------------------------------------
    def msm_g1(self, points: Sequence, scalars: Sequence[int]):
        """Σ scalars[i] * points[i] over G1 (Jacobian int triples).  A
        backend may return None to decline (e.g. batch too small), in which
        case the host loop runs."""
        if self._msm_g1_backend is not None:
            out = self._msm_g1_backend(points, scalars)
            if out is not None:
                return out
        g1 = self.bn.g1
        acc = g1.zero()
        for p, s in zip(points, scalars):
            acc = g1.add(acc, g1.mul_scalar(p, s))
        return acc

    def msm_g2(self, points: Sequence, scalars: Sequence[int]):
        """Σ scalars[i] * points[i] over G2 (Jacobian Fq2 triples)."""
        if self._msm_g2_backend is not None:
            out = self._msm_g2_backend(points, scalars)
            if out is not None:
                return out
        g2 = self.bn.g2
        acc = g2.zero()
        for p, s in zip(points, scalars):
            acc = g2.add(acc, g2.mul_scalar(p, s))
        return acc

    # -- batched fixed-base scalar mul (setup commitments) ------------------
    def batch_g1(self, scalars: Sequence[int]):
        """[k_i] -> [k_i * G1] (generator fixed base)."""
        if self._batch_g1_backend is not None:
            out = self._batch_g1_backend(scalars)
            if out is not None:
                return out
        g1 = self.bn.g1
        return [g1.mul_scalar(g1.g, s) for s in scalars]

    def batch_g2(self, scalars: Sequence[int]):
        if self._batch_g2_backend is not None:
            out = self._batch_g2_backend(scalars)
            if out is not None:
                return out
        g2 = self.bn.g2
        return [g2.mul_scalar(g2.g, s) for s in scalars]


_DEFAULT: Optional[ProtocolContext] = None


def default_context() -> ProtocolContext:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ProtocolContext()
    return _DEFAULT


def set_msm_backend(g1_backend: Optional[Callable], g2_backend: Optional[Callable] = None):
    """Install MSM backends on the default context (the card's Pippenger
    engine, :func:`.accel.enable_gpu_msm`).  Pass None to restore the host
    loops."""
    ctx = default_context()
    ctx._msm_g1_backend = g1_backend
    ctx._msm_g2_backend = g2_backend
