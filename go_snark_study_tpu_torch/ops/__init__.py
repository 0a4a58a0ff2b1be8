"""Device compute of the port.

The JAX package's exports (``go_snark_study_tpu/ops/__init__.py``): the
limb layout's constants and ``FieldKernels``.  Importing builds no kernel.
"""

from .limbs import LIMB_BITS, LIMBS, FieldKernels

__all__ = ["LIMBS", "LIMB_BITS", "FieldKernels"]
