"""Conversion between the JAX package's limb layout and the port's.

The JAX package stores a field element as (32, N) int32 holding 8-bit
limbs; the port stores (8, N) int32 holding 32-bit limbs.  Both hold the
same canonical Montgomery integer (R = 2^256), so conversion is a pure
re-packing of bytes.  Arrays cross between the two packages as numpy
arrays; nothing here imports JAX.

:func:`device_pk_from_jax` carries a JAX ``DevicePk`` over to the port, so
that both provers can run on one key.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.groth16_fast import DevicePk
from .ops.limbs import resolve_device

__all__ = ["jax_to_port", "port_to_jax", "device_pk_from_jax"]


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
