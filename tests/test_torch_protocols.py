"""The port's parity path (``api``, ``models.groth16``, ``models.pinocchio``,
``r1csqap``) with every hook off, held against the JAX package's, which is
pure Python here: the same compiled bundle, and for a seeded ``rng`` the same
setup and proof integer for integer; proofs verify and a wrong public input
fails.  Keys and proofs carried across with ``interop`` prove and verify in
the other package.
"""

import dataclasses
import random

import pytest

from go_snark_study_tpu import api as japi
from go_snark_study_tpu.models import groth16 as jg16
from go_snark_study_tpu.models import pinocchio as jpin
from go_snark_study_tpu_torch import api
from go_snark_study_tpu_torch.interop import parity_proof_from_jax, parity_setup_from_jax
from go_snark_study_tpu_torch.models import groth16, pinocchio

from test_torch_accel import CUBIC

MULTIPLICATION = """
func main(private a, private b, public c):
	d = a * b
	equals(c, d)
	out = 1 * 1
"""

CIRCUITS = {"cubic": (CUBIC, [3], [35]), "multiplication": (MULTIPLICATION, [42, 56], [2352])}
PROTOCOLS = {"groth16": (api.groth16_flow, japi.groth16_flow, groth16, jg16),
             "pinocchio": (api.pinocchio_flow, japi.pinocchio_flow, pinocchio, jpin)}
BUNDLE_FIELDS = ("witness", "alphas", "betas", "gammas", "zx", "px")


@pytest.fixture(scope="module")
def bundles():
    out = {}
    for name, (src, priv, pub) in CIRCUITS.items():
        out[name] = (api.compile_circuit(source=src, private_inputs=priv, public_inputs=pub),
                     japi.compile_circuit(source=src, private_inputs=priv, public_inputs=pub))
    return out


@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_compile_circuit_matches_jax(bundles, circuit):
    got, want = bundles[circuit]
    for f in BUNDLE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.circuit.signals == want.circuit.signals
    assert got.circuit.n_public == want.circuit.n_public


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_flow_matches_jax(bundles, circuit, protocol):
    flow, jflow, mod, _ = PROTOCOLS[protocol]
    got_b, want_b = bundles[circuit]
    setup, proof, ok = flow(got_b, rng=random.Random(11))
    jsetup, jproof, jok = jflow(want_b, rng=random.Random(11))
    assert ok and jok
    assert dataclasses.asdict(setup) == dataclasses.asdict(jsetup)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    publics = got_b.witness[1 : got_b.circuit.n_public + 1]
    assert not mod.verify_proof(setup.vk, proof, [publics[0] + 1])


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_verify_proof_takes_debug(bundles, protocol, capsys):
    """``verify_proof(vk, proof, publics, debug)`` as the reference orders
    it: the fourth positional argument is ``debug``, not the context."""
    flow, _, mod, _ = PROTOCOLS[protocol]
    bundle = bundles["cubic"][0]
    setup, proof, _ = flow(bundle, rng=random.Random(12))
    assert mod.verify_proof(setup.vk, proof, [35], False)
    assert capsys.readouterr().out == ""
    assert not mod.verify_proof(setup.vk, proof, [36], debug=True)
    assert "❌" in capsys.readouterr().out


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_keys_carry_across_packages(bundles, protocol):
    """A JAX key, carried over with ``parity_setup_from_jax``, proves in the
    port as it proves in JAX; the port's key proves in JAX; and a JAX proof
    carried over verifies under the port's verifier."""
    _, _, mod, jmod = PROTOCOLS[protocol]
    got_b, want_b = bundles["multiplication"]
    c = want_b.circuit
    jsetup = jmod.generate_trusted_setup(len(want_b.witness), c, want_b.alphas, want_b.betas,
                                         want_b.gammas, rng=random.Random(13))
    setup = parity_setup_from_jax(jsetup)
    assert type(setup) is mod.Setup and type(setup.pk) is mod.Pk
    assert dataclasses.asdict(setup) == dataclasses.asdict(jsetup)
    prove = {"groth16": lambda m, circ, pk, b: m.generate_proofs(circ, pk, b.witness, b.px, rng=random.Random(14)),
             "pinocchio": lambda m, circ, pk, b: m.generate_proofs(circ, pk, b.witness, b.px)}[protocol]
    jproof = prove(jmod, c, jsetup.pk, want_b)
    proof = prove(mod, got_b.circuit, setup.pk, got_b)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    assert dataclasses.asdict(prove(jmod, c, setup.pk, want_b)) == dataclasses.asdict(jproof)
    carried = parity_proof_from_jax(jproof)
    assert type(carried) is mod.Proof
    assert mod.verify_proof(setup.strip_toxic().vk, carried, [2352])
    assert jmod.verify_proof(jsetup.vk, proof, [2352])
