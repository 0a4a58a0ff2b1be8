"""Groth16 proof system (eprint 2016/260): the monomial-basis parity path
and the verifier.

Copy of ``go_snark_study_tpu/models/groth16.py`` (reference:
groth16/groth16.go).  The fixed-base commitments go through
``ctx.batch_g1/g2`` and the prover's sums through ``ctx.msm_g1/g2``, which
:mod:`.accel` sends to the card.  The evaluation-form prover for large
circuits is :mod:`.groth16_fast`.  Same artifact shapes (3-element proof,
Pk/Vk field-for-field) and the reference's structural conventions:

  * Z(x) roots 1..len(alphas)-2 (groth16.go:122-132; same quirk as
    Pinocchio — mirrored for artifact parity).
  * PowersTauDelta = { tau^i * Z(tau)/delta * G1 } — every ladder entry is
    pre-scaled by Z(tau)/delta (groth16.go:139-149), a reference-specific
    convention the prover's H-term sum relies on.
  * BACDelta zero-padded for public indices (groth16.go:192-200);
    IC = same formula /gamma over public indices (groth16.go:202-219).
  * fresh per-proof randomisers r, s (groth16.go:231-238) — seedable here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ..circuitcompiler import Circuit
from .context import ProtocolContext, default_context

__all__ = [
    "Pk",
    "Vk",
    "Toxic",
    "Setup",
    "Proof",
    "generate_trusted_setup",
    "generate_proofs",
    "assemble_proof",
    "verify_proof",
]


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

    def strip_toxic(self) -> "Setup":
        return Setup(toxic=Toxic(), pk=self.pk, vk=self.vk)


@dataclass
class Proof:
    """3-element Groth16 proof (groth16.go:61-65)."""

    pi_a: tuple = None  # G1
    pi_b: tuple = None  # G2
    pi_c: tuple = None  # G1


def generate_trusted_setup(
    witness_length: int,
    circuit: Circuit,
    alphas,
    betas,
    gammas,
    ctx: Optional[ProtocolContext] = None,
    rng=None,
) -> Setup:
    """Reference: groth16.go:94-222."""
    ctx = ctx or default_context()
    bn, fqr, pf = ctx.bn, ctx.fqr, ctx.pf
    g1, g2 = bn.g1, bn.g2

    tox = Toxic(
        t=ctx.rand_fr(rng),
        kalpha=ctx.rand_fr(rng),
        kbeta=ctx.rand_fr(rng),
        kgamma=ctx.rand_fr(rng),
        kdelta=ctx.rand_fr(rng),
    )
    setup = Setup(toxic=tox)
    pk, vk = setup.pk, setup.vk

    pk.z = pf.vanishing_reference(len(alphas))
    zt = pf.eval(pk.z, tox.t)
    inv_delta = fqr.inverse(tox.kdelta)
    zt_inv_delta = fqr.mul(inv_delta, zt)

    # powers of tau * Z(tau)/delta in G1 (groth16.go:139-149).  NB the
    # reference's ladder: entry 0 = Z(t)/delta * G1, entry i>=1 =
    # t^i * Z(t)/delta * G1.  All fixed-base -> batched hook.
    ladder = [zt_inv_delta]
    t_encr = tox.t
    for _ in range(1, len(pk.z)):
        ladder.append(fqr.mul(t_encr, zt_inv_delta))
        t_encr = fqr.mul(t_encr, tox.t)
    pk.powers_tau_delta = ctx.batch_g1(ladder)

    pk.g1.alpha = g1.mul_scalar(g1.g, tox.kalpha)
    pk.g1.beta = g1.mul_scalar(g1.g, tox.kbeta)
    pk.g1.delta = g1.mul_scalar(g1.g, tox.kdelta)
    pk.g2.beta = g2.mul_scalar(g2.g, tox.kbeta)
    # the reference leaves Pk.G2.Gamma unset (nil — its JSON string
    # round-trip emits "<nil>", groth16.go:15-32 vs base10parsers.go); we
    # populate it properly and the codecs tolerate the reference's nil.
    pk.g2.gamma = g2.mul_scalar(g2.g, tox.kgamma)
    pk.g2.delta = g2.mul_scalar(g2.g, tox.kdelta)

    vk.g1.alpha = g1.mul_scalar(g1.g, tox.kalpha)
    vk.g2.beta = g2.mul_scalar(g2.g, tox.kbeta)
    vk.g2.gamma = g2.mul_scalar(g2.g, tox.kgamma)
    vk.g2.delta = g2.mul_scalar(g2.g, tox.kdelta)

    # evaluate all signal polynomials at tau once (the reference re-evaluates
    # inside three separate loops, groth16.go:162-219 — same values).
    ats = [pf.eval(alphas[i], tox.t) for i in range(len(circuit.signals))]
    bts = [pf.eval(betas[i], tox.t) for i in range(len(circuit.signals))]
    cts = [pf.eval(gammas[i], tox.t) for i in range(len(circuit.signals))]

    pk.g1.at = ctx.batch_g1(ats)
    pk.g1.bacgamma = ctx.batch_g1(bts)
    pk.g2.bacgamma = ctx.batch_g2(bts)

    bac = [
        fqr.add(
            fqr.add(fqr.mul(ats[i], tox.kbeta), fqr.mul(bts[i], tox.kalpha)),
            cts[i],
        )
        for i in range(circuit.n_vars)
    ]
    lo = circuit.n_public + 1
    pk.bacdelta = [g1.zero()] * lo + ctx.batch_g1(
        [fqr.mul(inv_delta, x) for x in bac[lo:]]
    )
    inv_gamma = fqr.inverse(tox.kgamma)
    vk.ic = ctx.batch_g1([fqr.mul(inv_gamma, x) for x in bac[:lo]])

    return setup


def generate_proofs(
    circuit: Circuit,
    pk: Pk,
    w: Sequence[int],
    px: Sequence[int],
    ctx: Optional[ProtocolContext] = None,
    rng=None,
) -> Proof:
    """Reference: groth16.go:225-279."""
    ctx = ctx or default_context()
    fqr, pf = ctx.fqr, ctx.pf

    r = ctx.rand_fr(rng)
    s = ctx.rand_fr(rng)

    hi = circuit.n_vars
    lo = circuit.n_public + 1
    w_all = [x % fqr.q for x in w[:hi]]
    w_priv = [x % fqr.q for x in w[lo:hi]]

    pi_a = ctx.msm_g1(pk.g1.at[:hi], w_all)
    pi_b_g1 = ctx.msm_g1(pk.g1.bacgamma[:hi], w_all)
    pi_b = ctx.msm_g2(pk.g2.bacgamma[:hi], w_all)
    pi_c = ctx.msm_g1(pk.bacdelta[lo:hi], w_priv)
    hx = pf.divisor_polynomial(px, pk.z)  # in-prover like groth16.go:266
    pi_h = ctx.msm_g1(pk.powers_tau_delta[: len(hx)], hx)
    return assemble_proof(ctx, pk, r, s, pi_a, pi_b_g1, pi_b, pi_c, pi_h)


def assemble_proof(ctx: ProtocolContext, pk: Pk, r: int, s: int, pi_a, pi_b_g1, pi_b, pi_c, pi_h) -> Proof:
    """The proof from the draws r, s and the five MSMs: Σ w_i At_i, Σ w_i
    B_i in G1 and in G2, Σ over the private w_i of BACDelta_i, and Σ h_i
    tau^i Z(tau)/delta (groth16.go:240-279).  Every prover assembles here."""
    g1, g2, fqr = ctx.bn.g1, ctx.bn.g2, ctx.fqr

    # piA = Σ w_i At_i + alpha + r*delta
    pi_a = g1.add(pi_a, pk.g1.alpha)
    pi_a = g1.add(pi_a, g1.mul_scalar(pk.g1.delta, r))

    # piB (and its G1 shadow) = Σ w_i B_i + beta + s*delta
    pi_b_g1 = g1.add(pi_b_g1, pk.g1.beta)
    pi_b = g2.add(pi_b, pk.g2.beta)
    pi_b_g1 = g1.add(pi_b_g1, g1.mul_scalar(pk.g1.delta, s))
    pi_b = g2.add(pi_b, g2.mul_scalar(pk.g2.delta, s))

    # piC += Σ h_i * (tau^i Z(tau)/delta) + s*piA + r*piB_G1 - r*s*delta
    pi_c = g1.add(pi_c, pi_h)
    pi_c = g1.add(pi_c, g1.mul_scalar(pi_a, s))
    pi_c = g1.add(pi_c, g1.mul_scalar(pi_b_g1, r))
    neg_rs = fqr.neg(fqr.mul(r, s))
    pi_c = g1.add(pi_c, g1.mul_scalar(pk.g1.delta, neg_rs))

    return Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def verify_proof(
    vk: Vk,
    proof: Proof,
    public_signals: Sequence[int],
    debug: bool = False,
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

    ok = fq12.equal(
        bn.pairing(proof.pi_a, proof.pi_b),
        fq12.mul(
            bn.pairing(vk.g1.alpha, vk.g2.beta),
            fq12.mul(
                bn.pairing(ic_publ, vk.g2.gamma),
                bn.pairing(proof.pi_c, vk.g2.delta),
            ),
        ),
    )
    if debug:
        print(("✓" if ok else "❌") + " groth16 verification " + ("passed" if ok else "not passed"))
    return ok
