"""Embeddable prover/verifier API — the wasm wrapper analog.

Copy of ``go_snark_study_tpu/embed.py``, over the port's protocols and
``utils.base10``.

Reference: wasm/go-snark-wasm-wrapper.go:21-246, which registers four JS
globals taking stringified JSON and returning JSON.  This module is the same
surface for embedding in any Python host (a browser-side analog would wrap
these via pyodide or a service endpoint; ``go_snark_study_tpu_torch.server`` serves
them over HTTP like wasm/server.js serves the demo page):

    generate_proofs(circuit_json, setup_json, px_json, inputs_json) -> proof_json
    verify_proofs(proof_json, setup_json, public_inputs_json) -> '{"verified": bool}'
    groth_generate_proofs(...) / groth_verify_proofs(...)

All payloads use the decimal *String wire dialect (the CLI's ``wasm`` flag
emits exactly these files — compiledcircuitString.json etc.).
"""

from __future__ import annotations

import json

from .models import groth16 as g16, pinocchio as pgh
from .utils import base10

__all__ = [
    "generate_proofs",
    "verify_proofs",
    "groth_generate_proofs",
    "groth_verify_proofs",
]


def _inputs(inputs_json: str):
    d = json.loads(inputs_json)
    return [int(x) for x in d]


def generate_proofs(circuit_json: str, setup_json: str, px_json: str, inputs_json: str) -> str:
    """Pinocchio prove (wasm wrapper: generateProofs, wrapper.go:28-95).
    Recomputes the witness from the provided inputs, proves with the
    deserialized proving key and precomputed px."""
    circuit = base10.circuit_from_dict(json.loads(circuit_json))
    setup = base10.setup_from_dict(json.loads(setup_json))
    px = base10.arr_i(json.loads(px_json))
    priv = _inputs(inputs_json)
    w = circuit.calculate_witness(priv, circuit.witness[1 : circuit.n_public + 1])
    proof = pgh.generate_proofs(circuit, setup.pk, w, px)
    return json.dumps(base10.proof_to_dict(proof))


def verify_proofs(proof_json: str, setup_json: str, public_json: str) -> str:
    proof = base10.proof_from_dict(json.loads(proof_json))
    setup = base10.setup_from_dict(json.loads(setup_json))
    publics = _inputs(public_json)
    ok = pgh.verify_proof(setup.vk, proof, publics)
    return json.dumps({"verified": bool(ok)})


def groth_generate_proofs(circuit_json: str, setup_json: str, px_json: str, inputs_json: str) -> str:
    circuit = base10.circuit_from_dict(json.loads(circuit_json))
    setup = base10.groth_setup_from_dict(json.loads(setup_json))
    px = base10.arr_i(json.loads(px_json))
    priv = _inputs(inputs_json)
    w = circuit.calculate_witness(priv, circuit.witness[1 : circuit.n_public + 1])
    proof = g16.generate_proofs(circuit, setup.pk, w, px)
    return json.dumps(base10.groth_proof_to_dict(proof))


def groth_verify_proofs(proof_json: str, setup_json: str, public_json: str) -> str:
    proof = base10.groth_proof_from_dict(json.loads(proof_json))
    setup = base10.groth_setup_from_dict(json.loads(setup_json))
    publics = _inputs(public_json)
    ok = g16.verify_proof(setup.vk, proof, publics)
    return json.dumps({"verified": bool(ok)})
