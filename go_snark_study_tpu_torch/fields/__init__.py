"""Host (exact, arbitrary-precision) finite-field layer.

The TPU-batched limb arithmetic lives in :mod:`go_snark_study_tpu_torch.ops`; this
package is the exact oracle and the latency-path implementation (pairing,
verifier, tiny circuits).  Mirrors the reference's ``fields`` package
(fields/fq.go, fq2.go, fq6.go, fq12.go).
"""

from .fq import Fq
from .tower import Fq2, Fq6, Fq12

__all__ = ["Fq", "Fq2", "Fq6", "Fq12"]
