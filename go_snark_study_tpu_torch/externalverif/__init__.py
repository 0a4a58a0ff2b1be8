"""External-toolchain interop: verify circom/snarkjs Groth16 proofs.

Copy of ``go_snark_study_tpu/externalverif/__init__.py``.
"""

from .circom import CircomProof, CircomVk, verify_from_circom

__all__ = ["CircomProof", "CircomVk", "verify_from_circom"]
