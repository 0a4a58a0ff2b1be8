"""Groth16 artifacts and verifier (eprint 2016/260).

Mirrors ``go_snark_study_tpu/models/groth16.py``, trimmed to the
``Pk``/``Vk``/``Proof``/``Setup``/``Toxic`` dataclasses and
:func:`verify_proof`.  The monomial-basis setup and prover of the parity path
(and with them the ``circuitcompiler`` import) are not carried over: the
port's prover is :mod:`.groth16_fast`.

Conventions kept from the reference (groth16/groth16.go):

  * PowersTauDelta = { tau^i * Z(tau)/delta * G1 } — every ladder entry is
    pre-scaled by Z(tau)/delta (groth16.go:139-149).
  * BACDelta zero-padded for public indices (groth16.go:192-200);
    IC = same formula /gamma over public indices (groth16.go:202-219).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .context import ProtocolContext, default_context

__all__ = ["Pk", "Vk", "Toxic", "Setup", "Proof", "verify_proof"]


@dataclass
class PkG1:
    alpha: tuple = None
    beta: tuple = None
    delta: tuple = None
    at: List = field(default_factory=list)
    bacgamma: List = field(default_factory=list)


@dataclass
class PkG2:
    beta: tuple = None
    gamma: tuple = None
    delta: tuple = None
    bacgamma: List = field(default_factory=list)


@dataclass
class Pk:
    """Proving key (groth16.go:15-32)."""

    bacdelta: List = field(default_factory=list)  # (beta*u_i+alpha*v_i+w_i)/delta, l+1..m
    z: List[int] = field(default_factory=list)
    g1: PkG1 = field(default_factory=PkG1)
    g2: PkG2 = field(default_factory=PkG2)
    powers_tau_delta: List = field(default_factory=list)


@dataclass
class VkG1:
    alpha: tuple = None


@dataclass
class VkG2:
    beta: tuple = None
    gamma: tuple = None
    delta: tuple = None


@dataclass
class Vk:
    """Verification key (groth16.go:33-43)."""

    ic: List = field(default_factory=list)
    g1: VkG1 = field(default_factory=VkG1)
    g2: VkG2 = field(default_factory=VkG2)


@dataclass
class Toxic:
    t: int = 0
    kalpha: int = 0
    kbeta: int = 0
    kgamma: int = 0
    kdelta: int = 0


@dataclass
class Setup:
    toxic: Toxic = field(default_factory=Toxic)
    pk: Pk = field(default_factory=Pk)
    vk: Vk = field(default_factory=Vk)


@dataclass
class Proof:
    """3-element Groth16 proof (groth16.go:61-65)."""

    pi_a: tuple = None  # G1
    pi_b: tuple = None  # G2
    pi_c: tuple = None  # G1


def verify_proof(
    vk: Vk,
    proof: Proof,
    public_signals: Sequence[int],
    ctx: Optional[ProtocolContext] = None,
) -> bool:
    """Single-equation Groth16 verification, 4 pairings
    (groth16.go:281-305): e(piA, piB) == e(alpha, beta) * e(Σ pub_i IC_i,
    gamma) * e(piC, delta)."""
    ctx = ctx or default_context()
    bn = ctx.bn
    g1, fq12 = bn.g1, bn.fq12

    ic_publ = vk.ic[0]
    for i, sig in enumerate(public_signals):
        ic_publ = g1.add(ic_publ, g1.mul_scalar(vk.ic[i + 1], sig))

    return fq12.equal(
        bn.pairing(proof.pi_a, proof.pi_b),
        fq12.mul(
            bn.pairing(vk.g1.alpha, vk.g2.beta),
            fq12.mul(
                bn.pairing(ic_publ, vk.g2.gamma),
                bn.pairing(proof.pi_c, vk.g2.delta),
            ),
        ),
    )
