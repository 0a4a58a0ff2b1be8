"""Shared kernel instances for the two BN128 moduli.

Mirrors ``go_snark_study_tpu/ops/fields.py``: ``fq_kernels()`` for the base
field (point coordinates), ``fr_kernels()`` for the scalar field (witness,
polynomials, NTT).  The JAX package keeps one instance per modulus; the
port keeps one per modulus and device.  ``device=None`` is the card, and
raises without one, as the port's other entry points do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..bn128 import constants as C
from .limbs import FieldKernels, resolve_device

__all__ = ["fq_kernels", "fr_kernels"]

_CACHE: Dict[Tuple[int, str], FieldKernels] = {}


def _kernels(p: int, device) -> FieldKernels:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # "cuda" and "cuda:0" are one card
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (p, str(dev))
    if key not in _CACHE:
        _CACHE[key] = FieldKernels(p, dev)
    return _CACHE[key]


def fq_kernels(device=None) -> FieldKernels:
    """The ``FieldKernels`` of the base field q on ``device``."""
    return _kernels(C.Q, device)


def fr_kernels(device=None) -> FieldKernels:
    """The ``FieldKernels`` of the scalar field r on ``device``."""
    return _kernels(C.R, device)
