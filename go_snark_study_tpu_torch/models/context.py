"""Shared protocol context: curve + scalar field.

Mirrors ``go_snark_study_tpu/models/context.py``, trimmed to what the fast
Groth16 slice needs: the curve (``bn``) and the seedable ``rand_fr``.  The
polynomial field (``r1csqap``) and the MSM / fixed-base hooks of the parity
path are not carried over, so their imports are gone too.
"""

from __future__ import annotations

from typing import Optional

from ..bn128 import Bn128, default_bn128
from ..fields import Fq

__all__ = ["ProtocolContext", "default_context"]


class ProtocolContext:
    def __init__(self, bn: Optional[Bn128] = None):
        self.bn = bn or default_bn128()
        self.fqr = Fq(self.bn.r)

    # -- randomness (seedable for deterministic parity tests) --------------
    def rand_fr(self, rng=None) -> int:
        if rng is not None:
            return rng.randrange(self.fqr.q)
        return self.fqr.rand()


_DEFAULT: Optional[ProtocolContext] = None


def default_context() -> ProtocolContext:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ProtocolContext()
    return _DEFAULT
