"""BN128 curve + pairing (host exact path).

Mirrors the reference's ``bn128`` package (bn128/bn128.go, g1.go, g2.go) with
derived constants and a fast final exponentiation.  Batched device point kernels
live in :mod:`go_snark_study_tpu_torch.ops.curve_ops`.
"""

from . import constants
from .curve import GroupG1, GroupG2
from .pairing import Bn128, default_bn128

__all__ = ["constants", "GroupG1", "GroupG2", "Bn128", "default_bn128"]
