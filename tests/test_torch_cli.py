"""The port's CLI (``go_snark_study_tpu_torch.cli``) against the JAX
package's, in-process, with the reference's working-directory file
protocol.

* The ``--fast`` flow on the CPU (``main(argv, device="cpu")``) on a
  30-link flat-code chain: compile, trusted setup into the binary key
  file, proof, verification, and a tampered public input that must fail;
  the JAX CLI's ``groth16 verify`` accepts the port's artifacts (host
  pairings only).  This is the file's one port setup and one port prove.
* The reference-dialect flows on the cubic circuit: both CLIs write the
  same ``compiledcircuit.json`` and ``px.json`` byte for byte, and a proof
  made by either CLI verifies under the other's ``verify``, for both
  protocols.
"""

import json
import os
import shutil

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBIC = os.path.join(REPO, "circuitexamples", "test.circuit")
CHAIN_LINKS = 30


def port_main(argv, cwd, **kw):
    from go_snark_study_tpu_torch.cli import main

    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(argv, **kw)
    finally:
        os.chdir(old)


def jax_main(argv, cwd):
    from go_snark_study_tpu.cli.main import main

    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(argv)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def fast_dir(tmp_path_factory):
    """compile --fast, groth16 trustedsetup --fast, groth16 genproofs
    --fast on the CPU; returns the directory and each command's exit
    code."""
    from chip_smoke import chain_source

    d = tmp_path_factory.mktemp("fast")
    src, priv, pub = chain_source(CHAIN_LINKS)
    (d / "chain.circuit").write_text(src)
    (d / "privateInputs.json").write_text(json.dumps([str(x) for x in priv]))
    (d / "publicInputs.json").write_text(json.dumps([str(x) for x in pub]))
    rcs = {}
    for argv in (["compile", "chain.circuit", "--fast"], ["groth16", "trustedsetup", "--fast"],
                 ["groth16", "genproofs", "--fast"]):
        rcs[" ".join(argv)] = port_main(argv, d, device="cpu")
    return d, rcs


def test_fast_flow_proves_and_verifies(fast_dir):
    d, rcs = fast_dir
    assert all(rc == 0 for rc in rcs.values()), rcs
    assert (d / "trustedsetup.npz").exists() and (d / "proofs.json").exists()
    assert not (d / "px.json").exists() and not (d / "trustedsetup.json").exists()
    assert set(json.loads((d / "proofs.json").read_text())) == {"PiA", "PiB", "PiC"}
    assert port_main(["groth16", "verify"], d) == 0


def test_fast_flow_tampered_public_fails(fast_dir, capsys):
    d, _ = fast_dir
    good = (d / "publicInputs.json").read_text()
    (d / "publicInputs.json").write_text(json.dumps([str(int(json.loads(good)[0]) + 1)]))
    try:
        assert port_main(["groth16", "verify"], d) == 1
        assert "verified: False" in capsys.readouterr().out
    finally:
        (d / "publicInputs.json").write_text(good)


def test_jax_cli_verifies_the_port_fast_artifacts(fast_dir):
    d, _ = fast_dir
    assert jax_main(["groth16", "verify"], d) == 0


def test_fast_commands_without_a_card_raise(fast_dir, monkeypatch):
    d, _ = fast_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["groth16", "trustedsetup", "--fast"], ["groth16", "genproofs", "--fast"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(argv, d)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """``compile test.circuit wasm`` by each CLI in a directory of its own."""
    dirs = {}
    for who, run in (("port", port_main), ("jax", jax_main)):
        d = tmp_path_factory.mktemp(f"ref-{who}")
        shutil.copy(CUBIC, d)
        (d / "privateInputs.json").write_text("[3]")
        (d / "publicInputs.json").write_text("[35]")
        assert run(["compile", "test.circuit", "wasm"], d) == 0
        dirs[who] = d
    return dirs


def test_reference_compile_outputs_equal_jax(compiled):
    for name in ("compiledcircuit.json", "px.json", "compiledcircuitString.json", "pxString.json"):
        assert (compiled["port"] / name).read_bytes() == (compiled["jax"] / name).read_bytes(), name
    d = json.loads((compiled["port"] / "compiledcircuitString.json").read_text())
    assert isinstance(d["Witness"][0], str)


@pytest.mark.parametrize("protocol", ["pinocchio", "groth16"])
@pytest.mark.parametrize("prover", ["port", "jax"])
def test_proof_verifies_under_the_other_cli(compiled, tmp_path, protocol, prover):
    """Trusted setup and proof by one CLI, verification by the other."""
    for name in os.listdir(compiled["port"]):
        shutil.copy(compiled["port"] / name, tmp_path)
    prove, verify = (port_main, jax_main) if prover == "port" else (jax_main, port_main)
    pre = ["groth16"] if protocol == "groth16" else []
    assert prove(pre + ["trustedsetup"], tmp_path) == 0
    assert prove(pre + ["genproofs"], tmp_path) == 0
    assert verify(pre + ["verify"], tmp_path) == 0


def test_command_tree_matches_jax():
    """The same commands, aliases and flags as the JAX CLI."""
    from go_snark_study_tpu.cli.main import build_parser as jax_parser
    from go_snark_study_tpu_torch.cli import build_parser

    def tree(parser):
        out = {}
        for action in parser._actions:
            if hasattr(action, "choices") and isinstance(action.choices, dict):
                for name, sub in action.choices.items():
                    out[name] = tree(sub)
            else:
                out[tuple(action.option_strings) or action.dest] = action.nargs
        return out

    assert tree(build_parser()) == tree(jax_parser())
