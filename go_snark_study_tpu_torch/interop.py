"""Conversion between the JAX package's limb layout and the port's.

The JAX package stores a field element as (32, N) int32 holding 8-bit
limbs; the port stores (8, N) int32 holding 32-bit limbs.  Both hold the
same canonical Montgomery integer (R = 2^256), so conversion is a pure
re-packing of bytes.  Arrays cross between the two packages as numpy
arrays; nothing here imports JAX.

:func:`device_pk_from_jax` carries a JAX ``DevicePk`` over to the port, so
that both provers can run on one key.  :func:`parity_setup_from_jax` and
:func:`parity_proof_from_jax` do the same for the parity protocols' host
artifacts (Groth16 and Pinocchio setups and proofs, Jacobian int tuples):
they read the JAX dataclasses' fields by name, so nothing of the JAX package
is imported.  The port's artifacts need no conversion the other way: the
JAX prover and verifier read the same field names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import groth16, pinocchio
from .models.groth16_fast import DevicePk
from .ops.limbs import resolve_device

__all__ = [
    "jax_to_port",
    "port_to_jax",
    "device_pk_from_jax",
    "parity_setup_from_jax",
    "parity_proof_from_jax",
]


def jax_to_port(arr: np.ndarray) -> np.ndarray:
    """(32, ...) 8-bit limbs -> (8, ...) 32-bit limbs, int32 both."""
    a = np.asarray(arr)
    assert a.shape[0] == 32, a.shape
    rest = a.shape[1:]
    b = np.ascontiguousarray(np.moveaxis(a.astype(np.uint8), 0, -1))  # (..., 32)
    return np.ascontiguousarray(np.moveaxis(b.view("<u4"), -1, 0)).view(np.int32).reshape((8,) + rest)


def port_to_jax(arr) -> np.ndarray:
    """(8, ...) 32-bit limbs (numpy or tensor) -> (32, ...) 8-bit limbs."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    a = np.asarray(arr)
    assert a.shape[0] == 8, a.shape
    rest = a.shape[1:]
    b = np.ascontiguousarray(np.moveaxis(a.astype(np.int32).view("<u4"), 0, -1))  # (..., 8)
    c = b.view(np.uint8)  # (..., 32)
    return np.ascontiguousarray(np.moveaxis(c, -1, 0)).astype(np.int32).reshape((32,) + rest)


def _point_from_jax(arr: np.ndarray, device):
    """(3, 32, L) G1 or (3, 2, 32, L) G2 coordinates -> port point pytree."""
    t = lambda x: torch.from_numpy(jax_to_port(x)).to(device)
    if arr.ndim == 3:
        return tuple(t(arr[i]) for i in range(3))
    assert arr.ndim == 4 and arr.shape[1] == 2, arr.shape
    return tuple((t(arr[i, 0]), t(arr[i, 1])) for i in range(3))


def device_pk_from_jax(arrays: dict, *, n: int, m: int, lo: int, device=None) -> DevicePk:
    """A JAX ``DevicePk``, handed over as numpy, -> the port's ``DevicePk``.

    ``arrays`` maps ``at``, ``b1``, ``cdelta``, ``ptau`` to (3, 32, lanes)
    arrays (the x, y, z coordinate leaves of a G1 point pytree, stacked) and
    ``b2`` to (3, 2, 32, lanes) (G2: coordinate, Fq2 component); ``n``,
    ``m``, ``lo`` are the key's domain size, signal count and first private
    index.  The padded lane counts come from the arrays."""
    device = resolve_device(device)
    pts = {k: _point_from_jax(np.asarray(arrays[k]), device) for k in ("at", "b1", "b2", "cdelta", "ptau")}
    return DevicePk(
        n=n,
        m=m,
        lo=lo,
        m_pad=int(np.asarray(arrays["at"]).shape[-1]),
        mp_pad=int(np.asarray(arrays["cdelta"]).shape[-1]),
        n_pad=int(np.asarray(arrays["ptau"]).shape[-1]),
        **pts,
    )


def _dataclass_from(obj, cls):
    """An instance of the port's dataclass ``cls`` with the fields of
    ``obj``, read by name; nested dataclasses (``Pk.g1`` ...) recursively,
    lists copied (their points are tuples of ints)."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(f.default_factory):
            v = _dataclass_from(v, f.default_factory)
        elif isinstance(v, list):
            v = list(v)
        kw[f.name] = v
    return cls(**kw)


def _protocol(is_pinocchio: bool):
    return pinocchio if is_pinocchio else groth16


def parity_setup_from_jax(setup):
    """A JAX ``groth16.Setup`` or ``pinocchio.Setup`` -> the port's, field
    by field.  The protocol is told by the proving key's fields (Pinocchio's
    has ``g1t``)."""
    return _dataclass_from(setup, _protocol(hasattr(setup.pk, "g1t")).Setup)


def parity_proof_from_jax(proof):
    """A JAX ``groth16.Proof`` or ``pinocchio.Proof`` -> the port's
    (Pinocchio's has ``pi_ap``)."""
    return _dataclass_from(proof, _protocol(hasattr(proof, "pi_ap")).Proof)
