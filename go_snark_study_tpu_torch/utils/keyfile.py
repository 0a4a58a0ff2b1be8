"""Binary (NPZ) key format of the fast path.

Port of ``go_snark_study_tpu/utils/keyfile.py``: the same file, so that a
key written by either package loads in the other.  ``trustedsetup --fast``
writes the device proving key as ONE uncompressed ``.npz`` next to a small
JSON header carrying the verifying key and the handful of host points the
prover needs:

  * members ``at.{0,1,2}``, ``b1.*``, ``cdelta.*``, ``ptau.*`` (G1: x, y, z)
    and ``b2.{ci}.{k}`` (G2: coordinate, Fq2 component), each a
    ``(32, lanes)`` int32 array holding 8-bit limbs — the JAX package's
    layout.  The port keeps ``(8, lanes)`` 32-bit limbs and converts with
    :func:`..interop.port_to_jax` / :func:`..interop.jax_to_port`; the
    canonical Montgomery integers are the same.  Storing a byte per int32
    makes a 2^16-constraint key about 156 MB;
  * ``header``: uint8 JSON with ``format`` = ``gosnark-fast-setup-v1``,
    ``n``, ``m``, ``lo``, ``m_pad``, ``mp_pad``, ``n_pad``, and ``vk``,
    ``pk_g1``, ``pk_g2`` in the reference's decimal wire dialect, so that
    ``verify`` interoperates with JSON-only consumers unchanged.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from ..bn128 import constants as C
from ..interop import jax_to_port, port_to_jax
from ..models import groth16 as g16
from ..models.groth16_fast import DevicePk
from ..ops.limbs import resolve_device
from . import base10

__all__ = ["save_fast_setup", "load_fast_setup", "load_fast_header", "KEYFILE"]

KEYFILE = "trustedsetup.npz"
FORMAT = "gosnark-fast-setup-v1"

# DevicePk point fields: G1 = (x, y, z) leaves, G2 = ((x0, x1), (y0, y1),
# (z0, z1))
_G1_FIELDS = ("at", "b1", "cdelta", "ptau")
_G2_FIELDS = ("b2",)


def _flatten(name: str, tree) -> Dict[str, np.ndarray]:
    out = {}
    if name in _G2_FIELDS:
        for ci, coord in enumerate(tree):
            for k, comp in enumerate(coord):
                out[f"{name}.{ci}.{k}"] = port_to_jax(comp)
    else:
        for ci, coord in enumerate(tree):
            out[f"{name}.{ci}"] = port_to_jax(coord)
    return out


def _unflatten(name: str, arrays, device) -> tuple:
    t = lambda key: torch.from_numpy(jax_to_port(arrays[key])).to(device)
    if name in _G2_FIELDS:
        return tuple(tuple(t(f"{name}.{ci}.{k}") for k in range(2)) for ci in range(3))
    return tuple(t(f"{name}.{ci}") for ci in range(3))


def save_fast_setup(path: str, setup: g16.Setup) -> None:
    """Persist a fast-path setup (``pk._device`` REQUIRED) as NPZ.  Toxic
    waste is never written (the Setup passed in should already be
    stripped)."""
    dpk = getattr(setup.pk, "_device", None)
    if dpk is None:
        raise ValueError("setup has no device proving key (run the fast setup)")
    arrays: Dict[str, np.ndarray] = {}
    for f in _G1_FIELDS + _G2_FIELDS:
        arrays.update(_flatten(f, getattr(dpk, f)))
    header = {
        "format": FORMAT,
        "n": dpk.n,
        "m": dpk.m,
        "lo": dpk.lo,
        "m_pad": dpk.m_pad,
        "mp_pad": dpk.mp_pad,
        "n_pad": dpk.n_pad,
        "vk": base10.groth_vk_to_dict(setup.vk),
        "pk_g1": {
            "alpha": base10.p3(setup.pk.g1.alpha),
            "beta": base10.p3(setup.pk.g1.beta),
            "delta": base10.p3(setup.pk.g1.delta),
        },
        "pk_g2": {
            "beta": base10.p32(setup.pk.g2.beta),
            "gamma": base10.p32(setup.pk.g2.gamma),
            "delta": base10.p32(setup.pk.g2.delta),
        },
    }
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def _read_header(data, path: str) -> dict:
    header = json.loads(bytes(data["header"]).decode())
    if header.get("format") != FORMAT:
        raise ValueError(f"not a fast-setup keyfile: {path}")
    return header


def _setup_from_header(header: dict) -> g16.Setup:
    setup = g16.Setup()
    setup.vk = base10.groth_vk_from_dict(header["vk"])
    pk = setup.pk
    pk.g1.alpha = base10.p3_i(header["pk_g1"]["alpha"])
    pk.g1.beta = base10.p3_i(header["pk_g1"]["beta"])
    pk.g1.delta = base10.p3_i(header["pk_g1"]["delta"])
    pk.g2.beta = base10.p32_i(header["pk_g2"]["beta"])
    pk.g2.gamma = base10.p32_i(header["pk_g2"]["gamma"])
    pk.g2.delta = base10.p32_i(header["pk_g2"]["delta"])
    n = int(header["n"])
    pk.z = [C.R - 1] + [0] * (n - 1) + [1]  # Z(x) = x^n - 1
    return setup


def load_fast_header(path: str) -> g16.Setup:
    """The header alone: a Setup with the verifying key and the prover's
    host points, and no device key (``pk._device`` unset).  Reads no
    array member and needs no card: what ``verify`` needs."""
    with np.load(path) as data:
        return _setup_from_header(_read_header(data, path))


def load_fast_setup(path: str, device=None) -> g16.Setup:
    """NPZ -> Setup with a proving key on ``device`` (``pk._device``; the
    card when None) ready for :meth:`..models.groth16_fast.FastGroth16.prove`:
    no host point materialisation, no re-packing."""
    device = resolve_device(device)
    with np.load(path) as data:
        header = _read_header(data, path)
        setup = _setup_from_header(header)
        setup.pk._device = DevicePk(
            n=int(header["n"]),
            m=int(header["m"]),
            lo=int(header["lo"]),
            m_pad=int(header["m_pad"]),
            mp_pad=int(header["mp_pad"]),
            n_pad=int(header["n_pad"]),
            **{f: _unflatten(f, data, device) for f in _G1_FIELDS + _G2_FIELDS},
        )
    return setup
