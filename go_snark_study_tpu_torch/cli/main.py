"""go-snark-cli-torch — the reference CLI's command tree and file protocol.

Port of ``go_snark_study_tpu/cli/main.py`` over the port's modules: the
same commands, aliases, flags, files, messages (GPU where the JAX package
names its accelerator) and exit codes.  ``main(argv, device=None)``: the
``--fast`` commands build ``FastGroth16(device=device)``, the card unless a
Python caller passes ``device="cpu"``; without a card they raise.  The
other commands run on the host and need no card (``groth16 verify`` reads
only the key file's header).  Kernels build at first use into
``build/torch_kernels/``; there is no compile cache to enable.

Reference: cli/main.go:28-549.  Commands: ``compile``, ``trustedsetup``,
``genproofs``, ``verify`` and the ``groth16`` subtree, operating on the same
hard-coded CWD files the reference uses (its de-facto checkpoint system,
SURVEY §5.4):

  privateInputs.json / publicInputs.json     (inputs, JSON arrays)
  compiledcircuit.json + px.json             (compile outputs)
  trustedsetup.json                          (setup, toxic stripped)
  proofs.json                                (proof)

With the ``wasm`` positional flag, compile/trustedsetup additionally write
the *String variants (compiledcircuitString.json, pxString.json,
trustedsetupString.json) consumed by the embeddable API — mirroring
cli/main.go:194-226, 294-299.

Divergences from the reference (documented, all safety fixes):
  * toxic values are NEVER printed (the reference leaks T to stdout,
    cli/main.go:271,435);
  * intermediate artifacts are not dumped wholesale to stdout;
  * errors raise/exit nonzero instead of panicking mid-library.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

from ..api import compile_circuit
from ..models import groth16 as g16, pinocchio as pgh
from ..models.context import default_context
from ..utils import base10, raw


def _read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)


def _read_inputs() -> tuple[List[int], List[int]]:
    def norm(v):
        return [int(x) for x in v]

    private = norm(_read_json("privateInputs.json"))
    public = norm(_read_json("publicInputs.json"))
    return private, public


def cmd_compile(args) -> int:
    private, public = _read_inputs()
    if getattr(args, "fast", False):
        # sparse large-circuit path: parse -> field-semantics witness (C++
        # evaluator) -> sparse R1CS satisfiability check.  No dense R1CS, no
        # O(n^2) QAP, no px.json — the fast protocol stages recompute the
        # sparse system in O(nnz) (the dense reference pipeline is memory-
        # impossible beyond ~2^14 constraints).
        from ..bn128.constants import R as FR_MOD
        from ..circuitcompiler import parse_file
        from ..synthetic import SparseR1CS

        circuit = parse_file(args.circuit)
        w = circuit.calculate_witness(private, public, field_modulus=FR_MOD)
        sparse = SparseR1CS.from_circuit(circuit, witness=w)
        if not sparse.check():
            print("error: witness does not satisfy the constraint system",
                  file=sys.stderr)
            return 1
        print(f"compiled circuit (fast): {len(circuit.signals)} signals, "
              f"{sparse.n_constraints} constraints, {circuit.n_public} public")
        _write_json("compiledcircuit.json", raw.circuit_to_dict(circuit))
        print("wrote compiledcircuit.json (sparse fast path: no px.json)")
        return 0
    bundle = compile_circuit(
        path=args.circuit, private_inputs=private, public_inputs=public
    )
    c = bundle.circuit
    print(f"compiled circuit: {len(c.signals)} signals, "
          f"{len(c.r1cs.A)} constraints, {c.n_public} public")
    _write_json("compiledcircuit.json", raw.circuit_to_dict(c))
    _write_json("px.json", raw.arr(bundle.px))
    if args.wasm:
        _write_json("compiledcircuitString.json", base10.circuit_to_dict(c))
        _write_json("pxString.json", base10.arr(bundle.px))
    print("wrote compiledcircuit.json, px.json")
    return 0


def _load_compiled():
    ctx = default_context()
    circuit = raw.circuit_from_dict(_read_json("compiledcircuit.json"))
    private, public = _read_inputs()
    w = circuit.calculate_witness(private, public)
    a, b, c = circuit.generate_r1cs()
    alphas, betas, gammas, zx = ctx.pf.r1cs_to_qap(a, b, c)
    _, _, _, px = ctx.pf.combine_polynomials(w, alphas, betas, gammas)
    return ctx, circuit, w, alphas, betas, gammas, zx, px


def cmd_trustedsetup(args) -> int:
    ctx, circuit, w, alphas, betas, gammas, _, _ = _load_compiled()
    setup = pgh.generate_trusted_setup(len(w), circuit, alphas, betas, gammas, ctx=ctx)
    stripped = setup.strip_toxic()
    _write_json("trustedsetup.json", raw.setup_to_dict(stripped))
    if args.wasm:
        _write_json("trustedsetupString.json", base10.setup_to_dict(stripped))
    print("trusted setup generated; toxic waste NOT persisted — destroy this process's memory")
    print("wrote trustedsetup.json")
    return 0


def cmd_genproofs(args) -> int:
    ctx, circuit, w, _, _, _, _, px = _load_compiled()
    setup = raw.setup_from_dict(_read_json("trustedsetup.json"))
    t0 = time.time()
    proof = pgh.generate_proofs(circuit, setup.pk, w, px, ctx=ctx)
    print(f"proof generated in {time.time()-t0:.3f}s")
    _write_json("proofs.json", raw.proof_to_dict(proof))
    print("wrote proofs.json")
    return 0


def cmd_verify(args) -> int:
    setup = raw.setup_from_dict(_read_json("trustedsetup.json"))
    proof = raw.proof_from_dict(_read_json("proofs.json"))
    public = [int(x) for x in _read_json("publicInputs.json")]
    t0 = time.time()
    ok = pgh.verify_proof(setup.vk, proof, public, debug=True)
    print(f"verified: {ok} ({time.time()-t0:.3f}s)")
    return 0 if ok else 1


def _load_compiled_sparse():
    """Compiled circuit -> SparseR1CS + field witness, the GPU fast path's
    input: O(nnz) end to end (sparse row emission, no dense R1CS, no
    O(n^2) QAP recomputation; C++ witness evaluator at >=256
    constraints)."""
    from ..bn128.constants import R as FR_MOD
    from ..synthetic import SparseR1CS

    circuit = raw.circuit_from_dict(_read_json("compiledcircuit.json"))
    private, public = _read_inputs()
    w = circuit.calculate_witness(private, public, field_modulus=FR_MOD)
    sparse = SparseR1CS.from_circuit(circuit, witness=w)
    return circuit, sparse


def cmd_groth16_trustedsetup(args) -> int:
    if getattr(args, "fast", False):
        from ..models.groth16_fast import FastGroth16
        from ..utils import keyfile

        fast = FastGroth16(device=args.device)
        _, sparse = _load_compiled_sparse()
        setup = fast.setup(sparse, materialize_host=False)
        stripped = setup.strip_toxic()
        keyfile.save_fast_setup(keyfile.KEYFILE, stripped)
        print("groth16 trusted setup generated (GPU evaluation-form path)")
        print(f"wrote {keyfile.KEYFILE} (binary fast-path key; "
              "use the non-fast setup for the JSON wire format)")
        return 0
    ctx, circuit, w, alphas, betas, gammas, _, _ = _load_compiled()
    setup = g16.generate_trusted_setup(len(w), circuit, alphas, betas, gammas, ctx=ctx)
    stripped = setup.strip_toxic()
    _write_json("trustedsetup.json", raw.groth_setup_to_dict(stripped))
    if args.wasm:
        _write_json("trustedsetupString.json", base10.groth_setup_to_dict(stripped))
    # a stale binary fast-path key would shadow this fresh JSON setup
    import os

    from ..utils import keyfile

    if os.path.exists(keyfile.KEYFILE):
        os.remove(keyfile.KEYFILE)
    print("groth16 trusted setup generated")
    print("wrote trustedsetup.json")
    return 0


def _load_groth_setup(device=None, device_key: bool = True):
    """trustedsetup.npz (binary fast-path key, preferred) or
    trustedsetup.json (reference wire format).  Without ``device_key``
    only the key file's header is read (the verifying key: no card)."""
    import os

    from ..utils import keyfile

    if os.path.exists(keyfile.KEYFILE):
        if not device_key:
            return keyfile.load_fast_header(keyfile.KEYFILE)
        return keyfile.load_fast_setup(keyfile.KEYFILE, device=device)
    return raw.groth_setup_from_dict(_read_json("trustedsetup.json"))


def cmd_groth16_genproofs(args) -> int:
    if getattr(args, "fast", False):
        from ..models.groth16_fast import FastGroth16

        fast = FastGroth16(device=args.device)
        _, sparse = _load_compiled_sparse()
        setup = _load_groth_setup(fast.device)
        t0 = time.time()
        proof = fast.prove(sparse, setup.pk)
        print(f"proof generated in {time.time()-t0:.3f}s (GPU fast path)")
        _write_json("proofs.json", raw.groth_proof_to_dict(proof))
        print("wrote proofs.json")
        return 0
    ctx, circuit, w, _, _, _, _, px = _load_compiled()
    setup = raw.groth_setup_from_dict(_read_json("trustedsetup.json"))
    t0 = time.time()
    proof = g16.generate_proofs(circuit, setup.pk, w, px, ctx=ctx)
    print(f"proof generated in {time.time()-t0:.3f}s")
    _write_json("proofs.json", raw.groth_proof_to_dict(proof))
    print("wrote proofs.json")
    return 0


def cmd_groth16_verify(args) -> int:
    setup = _load_groth_setup(device_key=False)
    proof = raw.groth_proof_from_dict(_read_json("proofs.json"))
    public = [int(x) for x in _read_json("publicInputs.json")]
    t0 = time.time()
    ok = g16.verify_proof(setup.vk, proof, public, debug=True)
    print(f"verified: {ok} ({time.time()-t0:.3f}s)")
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="go-snark-cli-torch",
        description="zkSNARK from circuit language to proof generation & verification (PyTorch/CUDA)",
    )
    p.add_argument("--config", help="(declared but unused — reference parity, cli/main.go:85)")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("compile", aliases=["c"], help="compile a circuit")
    c.add_argument("circuit", help="path to .circuit file")
    c.add_argument(
        "--fast",
        action="store_true",
        help="sparse large-circuit path: field-mode witness (C++), O(nnz) "
        "R1CS, no dense QAP artifacts",
    )
    c.add_argument("wasm", nargs="?", help="also write *String JSON variants")
    c.set_defaults(fn=cmd_compile)

    t = sub.add_parser("trustedsetup", aliases=["t"], help="generate trusted setup for a circuit")
    t.add_argument("wasm", nargs="?")
    t.set_defaults(fn=cmd_trustedsetup)

    g = sub.add_parser("genproofs", aliases=["g"], help="generate the snark proofs")
    g.set_defaults(fn=cmd_genproofs)

    v = sub.add_parser("verify", aliases=["v"], help="verify the snark proofs")
    v.set_defaults(fn=cmd_verify)

    g16p = sub.add_parser("groth16", help="use groth16 protocol")
    g16sub = g16p.add_subparsers(dest="subcommand", required=True)
    gt = g16sub.add_parser("trustedsetup", aliases=["t"])
    gt.add_argument(
        "--fast",
        action="store_true",
        help="GPU evaluation-form setup (roots-of-unity domain, device MSMs)",
    )
    gt.add_argument("wasm", nargs="?")
    gt.set_defaults(fn=cmd_groth16_trustedsetup)
    gg = g16sub.add_parser("genproofs", aliases=["g"])
    gg.add_argument(
        "--fast",
        action="store_true",
        help="GPU fast prover (device MSMs + NTT H pipeline)",
    )
    gg.set_defaults(fn=cmd_groth16_genproofs)
    gv = g16sub.add_parser("verify", aliases=["v"])
    gv.set_defaults(fn=cmd_groth16_verify)

    return p


def main(argv=None, device=None) -> int:
    """Run one command.  ``device`` (Python callers only, not a flag): where
    the ``--fast`` commands run; None is the card."""
    args = build_parser().parse_args(argv)
    args.wasm = getattr(args, "wasm", None) == "wasm"
    args.device = device
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: missing file: {e.filename} "
              "(run the previous pipeline stage first, and provide "
              "privateInputs.json / publicInputs.json in the working dir)",
              file=sys.stderr)
        return 1
    except (json.JSONDecodeError, KeyError, ValueError) as e:
        print(f"error: malformed artifact: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
