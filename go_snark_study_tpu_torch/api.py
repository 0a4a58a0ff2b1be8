"""High-level convenience API: the full compile -> QAP -> setup -> prove ->
verify pipelines for both protocols.

Copy of ``go_snark_study_tpu/api.py``: the programmatic equivalent of the
reference's CLI flow (cli/main.go:95-397).  Everything here is host code;
:func:`.models.accel.enable_gpu_msm` and :func:`.models.accel.enable_gpu_setup`
send the protocols' MSMs and fixed-base commitments to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .circuitcompiler import Circuit, parse_file, parse_source
from .models import groth16, pinocchio
from .models.context import ProtocolContext, default_context

__all__ = ["CompiledBundle", "compile_circuit", "pinocchio_flow", "groth16_flow"]


@dataclass
class CompiledBundle:
    """Everything the CLI persists as compiledcircuit.json + px.json."""

    circuit: Circuit
    witness: List[int]
    alphas: list
    betas: list
    gammas: list
    zx: List[int]
    px: List[int]


def compile_circuit(
    source: Optional[str] = None,
    path: Optional[str] = None,
    private_inputs: Sequence[int] = (),
    public_inputs: Sequence[int] = (),
    ctx: Optional[ProtocolContext] = None,
) -> CompiledBundle:
    """parse -> witness -> R1CS -> QAP -> px, with the reference's sanity
    identities asserted (cli/main.go:155-181)."""
    ctx = ctx or default_context()
    pf = ctx.pf
    if (source is None) == (path is None):
        raise ValueError("pass exactly one of source= or path=")
    circuit = parse_source(source) if source is not None else parse_file(path)
    w = circuit.calculate_witness(list(private_inputs), list(public_inputs))
    a, b, c = circuit.generate_r1cs()
    alphas, betas, gammas, zx = pf.r1cs_to_qap(a, b, c)
    ax, bx, cx, px = pf.combine_polynomials(w, alphas, betas, gammas)
    hx = pf.divisor_polynomial(px, zx)
    # sanity: px == hx*zx and (ax*bx - cx) == px, remainder-free
    abc = pf.sub(pf.mul(ax, bx), cx)
    if abc != px:
        raise AssertionError("(a*b-c) != px")
    hz = pf.mul(hx, zx)
    if pf.sub(hz, px) != [0] * max(len(hz), len(px)):
        raise AssertionError("px != hx*zx")
    _, rem = pf.div(px, zx)
    if any(x != 0 for x in rem):
        raise AssertionError("px % zx != 0")
    return CompiledBundle(circuit, w, alphas, betas, gammas, zx, px)


def pinocchio_flow(
    bundle: CompiledBundle,
    ctx: Optional[ProtocolContext] = None,
    rng=None,
    debug: bool = False,
):
    """setup -> prove -> verify on a compiled bundle; returns
    (setup, proof, ok)."""
    ctx = ctx or default_context()
    circuit, w = bundle.circuit, bundle.witness
    setup = pinocchio.generate_trusted_setup(
        len(w), circuit, bundle.alphas, bundle.betas, bundle.gammas, ctx=ctx, rng=rng
    )
    proof = pinocchio.generate_proofs(circuit, setup.pk, w, bundle.px, ctx=ctx)
    publics = w[1 : circuit.n_public + 1]
    ok = pinocchio.verify_proof(setup.vk, proof, publics, debug=debug, ctx=ctx)
    return setup, proof, ok


def groth16_flow(
    bundle: CompiledBundle,
    ctx: Optional[ProtocolContext] = None,
    rng=None,
    debug: bool = False,
):
    ctx = ctx or default_context()
    circuit, w = bundle.circuit, bundle.witness
    setup = groth16.generate_trusted_setup(
        len(w), circuit, bundle.alphas, bundle.betas, bundle.gammas, ctx=ctx, rng=rng
    )
    proof = groth16.generate_proofs(circuit, setup.pk, w, bundle.px, ctx=ctx, rng=rng)
    publics = w[1 : circuit.n_public + 1]
    ok = groth16.verify_proof(setup.vk, proof, publics, debug=debug, ctx=ctx)
    return setup, proof, ok
