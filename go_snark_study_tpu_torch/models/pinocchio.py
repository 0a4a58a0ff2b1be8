"""Pinocchio / PGHR13 proof system (eprint 2013/279-style).

Copy of ``go_snark_study_tpu/models/pinocchio.py`` (reference: snark.go,
the repo-root ``snark`` package).  Same artifact shapes (8-element proof,
Pk/Vk field-for-field), same structural choices:

  * Z(x) roots 1..len(alphas)-2 (snark.go:221-232 — nSignals-2, not the
    constraint count; mirrored for artifact parity).
  * IC = the first NPublic+1 A-commitments (snark.go:187-189).
  * the per-signal K-consistency self check (snark.go:207-211) — but raising
    ``SetupError`` instead of the reference's mid-library ``os.Exit(1)``.
  * prover MSM split: PiA/PiAp over private signals only
    (i in [NPublic+1, NVars)), the other five sums over all signals
    (snark.go:265-278); H(x) = P(x)/Z(x) recomputed inside the prover
    (snark.go:280) exactly like the reference.

Randomness (toxic scalars) is seedable via ``rng`` for deterministic tests;
production callers omit it and get CSPRNG sampling.
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
    "SetupError",
    "generate_trusted_setup",
    "generate_proofs",
    "verify_proof",
]


class SetupError(Exception):
    pass


@dataclass
class Pk:
    """Proving key (snark.go:16-26)."""

    g1t: List = field(default_factory=list)  # powers-of-t ladder in G1
    a: List = field(default_factory=list)
    b: List = field(default_factory=list)  # G2 points
    c: List = field(default_factory=list)
    kp: List = field(default_factory=list)
    ap: List = field(default_factory=list)
    bp: List = field(default_factory=list)
    cp: List = field(default_factory=list)
    z: List[int] = field(default_factory=list)


@dataclass
class Vk:
    """Verification key (snark.go:28-37)."""

    vka: tuple = None  # G2
    vkb: tuple = None  # G1
    vkc: tuple = None  # G2
    ic: List = field(default_factory=list)  # G1 points
    g1_kbg: tuple = None  # g1 * Kbeta*Kgamma
    g2_kbg: tuple = None  # g2 * Kbeta*Kgamma
    g2_kg: tuple = None  # g2 * Kgamma
    vkz: tuple = None  # G2


@dataclass
class Toxic:
    """Trusted-setup secrets — must be destroyed (snark.go:41-51)."""

    t: int = 0
    ka: int = 0
    kb: int = 0
    kc: int = 0
    kbeta: int = 0
    kgamma: int = 0
    rho_a: int = 0
    rho_b: int = 0
    rho_c: int = 0


@dataclass
class Setup:
    toxic: Toxic = field(default_factory=Toxic)
    pk: Pk = field(default_factory=Pk)
    vk: Vk = field(default_factory=Vk)

    def strip_toxic(self) -> "Setup":
        """The CLI persists setups with the toxic struct zeroed
        (cli/main.go:274-277)."""
        return Setup(toxic=Toxic(), pk=self.pk, vk=self.vk)


@dataclass
class Proof:
    """8-element PGHR13 proof (snark.go:59-69)."""

    pi_a: tuple = None
    pi_ap: tuple = None
    pi_b: tuple = None  # G2
    pi_bp: tuple = None
    pi_c: tuple = None
    pi_cp: tuple = None
    pi_h: tuple = None
    pi_kp: tuple = None


def generate_trusted_setup(
    witness_length: int,
    circuit: Circuit,
    alphas,
    betas,
    gammas,
    ctx: Optional[ProtocolContext] = None,
    rng=None,
) -> Setup:
    """Reference: snark.go:98-252."""
    ctx = ctx or default_context()
    bn, fqr, pf = ctx.bn, ctx.fqr, ctx.pf
    g1, g2 = bn.g1, bn.g2

    tox = Toxic(
        t=ctx.rand_fr(rng),
        ka=ctx.rand_fr(rng),
        kb=ctx.rand_fr(rng),
        kc=ctx.rand_fr(rng),
        kbeta=ctx.rand_fr(rng),
        kgamma=ctx.rand_fr(rng),
        rho_a=ctx.rand_fr(rng),
        rho_b=ctx.rand_fr(rng),
    )
    tox.rho_c = fqr.mul(tox.rho_a, tox.rho_b)

    setup = Setup(toxic=tox)
    vk, pk = setup.vk, setup.pk

    vk.vka = g2.mul_scalar(g2.g, tox.ka)
    vk.vkb = g1.mul_scalar(g1.g, tox.kb)
    vk.vkc = g2.mul_scalar(g2.g, tox.kc)

    kbg = fqr.mul(tox.kbeta, tox.kgamma)
    vk.g1_kbg = g1.mul_scalar(g1.g, kbg)
    vk.g2_kbg = g2.mul_scalar(g2.g, kbg)
    vk.g2_kg = g2.mul_scalar(g2.g, tox.kgamma)

    # per-signal commitments (snark.go:181-218).  The reference evaluates and
    # commits one signal at a time with 254-bit double-and-add ladders; here
    # every commitment is a known-scalar multiple of a generator, so they all
    # go through the batched fixed-base hook (the card's engine when installed,
    # :mod:`.accel`).
    n_sig = len(circuit.signals)
    ats = [pf.eval(alphas[i], tox.t) for i in range(n_sig)]
    bts = [pf.eval(betas[i], tox.t) for i in range(n_sig)]
    cts = [pf.eval(gammas[i], tox.t) for i in range(n_sig)]
    ra = [fqr.mul(tox.rho_a, x) for x in ats]
    rb = [fqr.mul(tox.rho_b, x) for x in bts]
    rc = [fqr.mul(tox.rho_c, x) for x in cts]
    kts = [fqr.add(fqr.add(a, b), c) for a, b, c in zip(ra, rb, rc)]

    pk.a = ctx.batch_g1(ra)
    bg1s = ctx.batch_g1(rb)
    pk.b = ctx.batch_g2(rb)
    pk.c = ctx.batch_g1(rc)
    pk.ap = ctx.batch_g1([fqr.mul(tox.ka, x) for x in ra])
    pk.bp = ctx.batch_g1([fqr.mul(tox.kb, x) for x in rb])
    pk.cp = ctx.batch_g1([fqr.mul(tox.kc, x) for x in rc])
    pk.kp = ctx.batch_g1([fqr.mul(tox.kbeta, x) for x in kts])
    vk.ic = pk.a[: circuit.n_public + 1]

    # K-commitment consistency self-check (snark.go:207-211; error, not
    # os.Exit): G*kt must equal A_i + B_i + C_i
    ks = ctx.batch_g1(kts)
    for i in range(n_sig):
        if g1.affine(ks[i]) != g1.affine(g1.add(g1.add(pk.a[i], bg1s[i]), pk.c[i])):
            raise SetupError(f"K-commitment consistency check failed at signal {i}")

    # vanishing polynomial with the reference's root-count quirk
    pk.z = pf.vanishing_reference(len(alphas))

    zt = pf.eval(pk.z, tox.t)
    vk.vkz = g2.mul_scalar(g2.g, fqr.mul(tox.rho_c, zt))

    # powers-of-t G1 ladder sized len(z) (snark.go:240-248)
    powers = [1]
    t_encr = tox.t
    for _ in range(1, len(pk.z)):
        powers.append(t_encr)
        t_encr = fqr.mul(t_encr, tox.t)
    pk.g1t = ctx.batch_g1(powers)

    return setup


def generate_proofs(
    circuit: Circuit,
    pk: Pk,
    w: Sequence[int],
    px: Sequence[int],
    ctx: Optional[ProtocolContext] = None,
) -> Proof:
    """Reference: snark.go:254-289.  The three serial MSM groups become
    ``ctx.msm_g1``/``msm_g2`` calls, which the card's Pippenger backend
    (:mod:`.accel`) runs when installed."""
    ctx = ctx or default_context()
    pf = ctx.pf

    lo, hi = circuit.n_public + 1, circuit.n_vars
    w_priv = [s % ctx.fqr.q for s in w[lo:hi]]
    w_all = [s % ctx.fqr.q for s in w[:hi]]

    pi_a = ctx.msm_g1(pk.a[lo:hi], w_priv)
    pi_ap = ctx.msm_g1(pk.ap[lo:hi], w_priv)
    pi_b = ctx.msm_g2(pk.b[:hi], w_all)
    pi_bp = ctx.msm_g1(pk.bp[:hi], w_all)
    pi_c = ctx.msm_g1(pk.c[:hi], w_all)
    pi_cp = ctx.msm_g1(pk.cp[:hi], w_all)
    pi_kp = ctx.msm_g1(pk.kp[:hi], w_all)

    hx = pf.divisor_polynomial(px, pk.z)  # recomputed in-prover like snark.go:280
    pi_h = ctx.msm_g1(pk.g1t[: len(hx)], hx)

    return Proof(pi_a, pi_ap, pi_b, pi_bp, pi_c, pi_cp, pi_h, pi_kp)


def verify_proof(
    vk: Vk,
    proof: Proof,
    public_signals: Sequence[int],
    debug: bool = False,
    ctx: Optional[ProtocolContext] = None,
) -> bool:
    """The five pairing-equation checks (snark.go:292-368), 10 pairings.
    Unlike the reference, nothing is printed unless ``debug`` (the reference
    leaks its K-check ❌ print even with debug=false, snark.go:360-363)."""
    ctx = ctx or default_context()
    bn = ctx.bn
    g1, g2, fq12 = bn.g1, bn.g2, bn.fq12

    def report(ok: bool, label: str) -> bool:
        if debug:
            print(("✓" if ok else "❌") + " " + label)
        return ok

    # knowledge commitment for A: e(piA, Vka) == e(piA', g2)
    if not report(
        fq12.equal(bn.pairing(proof.pi_a, vk.vka), bn.pairing(proof.pi_ap, g2.g)),
        "e(piA, Va) == e(piA', g2), valid knowledge commitment for A",
    ):
        return False
    # knowledge commitment for B: e(Vkb, piB) == e(piB', g2)
    if not report(
        fq12.equal(bn.pairing(vk.vkb, proof.pi_b), bn.pairing(proof.pi_bp, g2.g)),
        "e(Vb, piB) == e(piB', g2), valid knowledge commitment for B",
    ):
        return False
    # knowledge commitment for C: e(piC, Vkc) == e(piC', g2)
    if not report(
        fq12.equal(bn.pairing(proof.pi_c, vk.vkc), bn.pairing(proof.pi_cp, g2.g)),
        "e(piC, Vc) == e(piC', g2), valid knowledge commitment for C",
    ):
        return False

    # Vkx = IC linear combination over public signals
    vkx = vk.ic[0]
    for i, s in enumerate(public_signals):
        vkx = g1.add(vkx, g1.mul_scalar(vk.ic[i + 1], s))

    vkx_pia = g1.add(vkx, proof.pi_a)
    # QAP divisibility: e(Vkx+piA, piB) == e(piH, Vkz) * e(piC, g2)
    if not report(
        fq12.equal(
            bn.pairing(vkx_pia, proof.pi_b),
            fq12.mul(bn.pairing(proof.pi_h, vk.vkz), bn.pairing(proof.pi_c, g2.g)),
        ),
        "e(Vkx+piA, piB) == e(piH, Vkz) * e(piC, g2), QAP divisibility checked",
    ):
        return False

    # K consistency: e(Vkx+piA+piC, G2Kbg) * e(G1Kbg, piB) == e(piKp, G2Kg)
    pi_apic = g1.add(vkx_pia, proof.pi_c)
    lhs = fq12.mul(bn.pairing(pi_apic, vk.g2_kbg), bn.pairing(vk.g1_kbg, proof.pi_b))
    rhs = bn.pairing(proof.pi_kp, vk.g2_kg)
    if not report(
        fq12.equal(lhs, rhs),
        "e(Vkx+piA+piC, g2KbetaKgamma) * e(g1KbetaKgamma, piB) == e(piK, g2Kgamma)",
    ):
        return False

    return True
