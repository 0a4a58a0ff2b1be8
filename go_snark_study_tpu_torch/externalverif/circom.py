"""Verify snarkjs/circom Groth16 artifacts.

Copy of ``go_snark_study_tpu/externalverif/circom.py``, over the port's
Groth16 verifier.

Reference: externalVerif/circomVerifier.go:12-90.  Parses snarkjs'
``verification_key.json`` / ``proof.json`` / ``public.json`` (decimal string
fields ``pi_a``/``pi_b``/``pi_c``, ``vk_alfa_1``/``vk_beta_2``/
``vk_gamma_2``/``vk_delta_2``/``IC``) and runs our Groth16 verifier — the
cross-implementation wire-format compatibility oracle.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..models import groth16
from ..models.context import ProtocolContext, default_context
from ..utils import base10

__all__ = ["CircomProof", "CircomVk", "verify_from_circom", "vk_from_circom_dict", "proof_from_circom_dict"]


@dataclass
class CircomProof:
    pi_a: tuple = None
    pi_b: tuple = None
    pi_c: tuple = None


@dataclass
class CircomVk:
    ic: List = field(default_factory=list)
    alpha1: tuple = None
    beta2: tuple = None
    gamma2: tuple = None
    delta2: tuple = None


def vk_from_circom_dict(d: dict) -> groth16.Vk:
    # points are on-curve/subgroup-validated at parse (utils/validate.py) —
    # snarkjs shares the reference's raw-tuple trust model otherwise
    vk = groth16.Vk()
    vk.ic = base10.arr_p3_i(d["IC"])
    vk.g1.alpha = base10.p3_i(d["vk_alfa_1"])
    vk.g2.beta = base10.p32_i(d["vk_beta_2"], subgroup=True)
    vk.g2.gamma = base10.p32_i(d["vk_gamma_2"], subgroup=True)
    vk.g2.delta = base10.p32_i(d["vk_delta_2"], subgroup=True)
    return vk


def proof_from_circom_dict(d: dict) -> groth16.Proof:
    return groth16.Proof(
        pi_a=base10.p3_i(d["pi_a"]),
        pi_b=base10.p32_i(d["pi_b"], subgroup=True),
        pi_c=base10.p3_i(d["pi_c"]),
    )


def verify_from_circom(
    vk_path: str,
    proof_path: str,
    public_signals_path: str,
    debug: bool = False,
    ctx: Optional[ProtocolContext] = None,
) -> bool:
    with open(vk_path) as fh:
        vk = vk_from_circom_dict(json.load(fh))
    with open(proof_path) as fh:
        proof = proof_from_circom_dict(json.load(fh))
    with open(public_signals_path) as fh:
        publics = [int(s) for s in json.load(fh)]
    return groth16.verify_proof(vk, proof, publics, debug=debug, ctx=ctx)
