"""Groth16 proof system of the port.

The JAX package's exports (``go_snark_study_tpu/models/__init__.py``): the
parity protocols and the protocol context with its MSM hook.
"""

from . import groth16, pinocchio
from .context import ProtocolContext, default_context, set_msm_backend

__all__ = ["groth16", "pinocchio", "ProtocolContext", "default_context", "set_msm_backend"]
