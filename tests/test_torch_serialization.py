"""The port's wire formats (``utils/serializers.py``, ``utils/validate.py``)
held against the JAX package's.

One seeded cubic-circuit setup and proof per package and protocol
(Pinocchio and Groth16; the JAX package's parity protocols are pure
Python): every artifact round-trips through real JSON in all three
dialects (decimal, hex, raw numbers), and the port's dicts equal the JAX
``Codec``'s string for string.  The point
validation at the wire boundary rejects off-curve and wrong-subgroup
points unless ``GOSNARK_VALIDATE=0``.
"""

import json
import random

import pytest
import torch

torch.set_num_threads(1)

CUBIC = """
func main(private s0, public s1):
	s2 = s0 * s0
	s3 = s2 * s0
	s4 = s3 + s0
	s5 = s4 + 5
	equals(s1, s5)
	out = 1 * 1
"""
CODECS = ("base10", "hexcodec", "raw")


def _flows(api, groth16, pinocchio):
    """Seeded setups and proofs of both protocols (the flows' steps without
    their verification: the CLI and embed tests verify)."""
    b = api.compile_circuit(source=CUBIC, private_inputs=[3], public_inputs=[35])
    rng = random.Random(77)
    args = (len(b.witness), b.circuit, b.alphas, b.betas, b.gammas)
    psetup = pinocchio.generate_trusted_setup(*args, rng=rng)
    pproof = pinocchio.generate_proofs(b.circuit, psetup.pk, b.witness, b.px)
    gsetup = groth16.generate_trusted_setup(*args, rng=rng)
    gproof = groth16.generate_proofs(b.circuit, gsetup.pk, b.witness, b.px, rng=rng)
    return b, psetup, pproof, gsetup, gproof


@pytest.fixture(scope="module")
def flows():
    from go_snark_study_tpu_torch import api
    from go_snark_study_tpu_torch.models import groth16, pinocchio

    return _flows(api, groth16, pinocchio)


@pytest.fixture(scope="module")
def jax_flows():
    from go_snark_study_tpu import api
    from go_snark_study_tpu.models import groth16, pinocchio

    return _flows(api, groth16, pinocchio)


def _codec(name):
    from go_snark_study_tpu_torch import utils

    return getattr(utils, name)


def _through_json(d):
    return json.loads(json.dumps(d))


def _dicts(codec, flows):
    bundle, psetup, pproof, gsetup, gproof = flows
    return {
        "circuit": codec.circuit_to_dict(bundle.circuit),
        "px": codec.arr(bundle.px),
        "setup": codec.setup_to_dict(psetup),
        "proof": codec.proof_to_dict(pproof),
        "groth_setup": codec.groth_setup_to_dict(gsetup),
        "groth_vk": codec.groth_vk_to_dict(gsetup.vk),
        "groth_proof": codec.groth_proof_to_dict(gproof),
    }


@pytest.mark.parametrize("name", CODECS)
def test_pinocchio_setup_roundtrip(flows, name):
    codec = _codec(name)
    _, psetup, _, _, _ = flows
    back = codec.setup_from_dict(_through_json(codec.setup_to_dict(psetup)))
    assert back.pk == psetup.pk
    assert back.vk == psetup.vk


@pytest.mark.parametrize("name", CODECS)
def test_pinocchio_proof_roundtrip(flows, name):
    codec = _codec(name)
    _, _, pproof, _, _ = flows
    assert codec.proof_from_dict(_through_json(codec.proof_to_dict(pproof))) == pproof


@pytest.mark.parametrize("name", CODECS)
def test_groth_setup_roundtrip(flows, name):
    codec = _codec(name)
    _, _, _, gsetup, _ = flows
    back = codec.groth_setup_from_dict(_through_json(codec.groth_setup_to_dict(gsetup)))
    assert back.pk == gsetup.pk
    assert back.vk == gsetup.vk


@pytest.mark.parametrize("name", CODECS)
def test_groth_proof_roundtrip(flows, name):
    codec = _codec(name)
    _, _, _, _, gproof = flows
    assert codec.groth_proof_from_dict(_through_json(codec.groth_proof_to_dict(gproof))) == gproof


@pytest.mark.parametrize("name", CODECS)
def test_circuit_roundtrip(flows, name):
    codec = _codec(name)
    c = flows[0].circuit
    back = codec.circuit_from_dict(_through_json(codec.circuit_to_dict(c)))
    assert back.signals == c.signals and back.witness == c.witness
    assert (back.r1cs.A, back.r1cs.B, back.r1cs.C) == (c.r1cs.A, c.r1cs.B, c.r1cs.C)
    assert [k.to_json() for k in back.constraints] == [k.to_json() for k in c.constraints]
    assert (back.n_public, back.private_inputs, back.public_inputs) == (c.n_public, c.private_inputs, c.public_inputs)


@pytest.mark.parametrize("name", CODECS)
def test_dicts_equal_the_jax_codecs(flows, jax_flows, name):
    """The same seeded flow serialises to the same JSON text in both
    packages, artifact by artifact."""
    from go_snark_study_tpu import utils as jax_utils

    got = _dicts(_codec(name), flows)
    want = _dicts(getattr(jax_utils, name), jax_flows)
    for key in want:
        assert json.dumps(got[key]) == json.dumps(want[key]), key


# ----------------------------------------------------------------------
# point validation at the wire boundary
# ----------------------------------------------------------------------
def _fq2_sqrt(a, q):
    """sqrt in Fq2 = Fq[u]/(u^2+1) for q = 3 mod 4; None if not a QR."""
    a0, a1 = a
    sq = lambda x: pow(x, (q + 1) // 4, q)
    is_qr = lambda x: x == 0 or pow(x, (q - 1) // 2, q) == 1
    if a1 == 0:
        return (sq(a0), 0) if is_qr(a0) else (0, sq((-a0) % q))
    norm = (a0 * a0 + a1 * a1) % q
    if not is_qr(norm):
        return None
    lam = sq(norm)
    inv2 = pow(2, -1, q)
    delta = (a0 + lam) * inv2 % q
    if not is_qr(delta):
        delta = (a0 - lam) * inv2 % q
        if not is_qr(delta):
            return None
    x0 = sq(delta)
    x1 = a1 * pow(2 * x0, -1, q) % q
    if (x0 * x0 - x1 * x1) % q == a0 and (2 * x0 * x1) % q == a1 % q:
        return (x0, x1)
    return None


def _twist_point_off_subgroup():
    """An on-twist point outside the r-torsion: hash-to-x on E'(Fq2)
    without cofactor clearing."""
    from go_snark_study_tpu_torch.bn128.constants import Q
    from go_snark_study_tpu_torch.utils.validate import _fq2_add, _fq2_mul, _twist_coef_b

    b2 = _twist_coef_b()
    for trial in range(1, 200):
        x = (trial, trial + 1)
        y = _fq2_sqrt(_fq2_add(_fq2_mul(_fq2_mul(x, x), x), b2), Q)
        if y is not None:
            return (x, y, (1, 0))
    raise AssertionError("no twist point found")


def test_offcurve_g1_rejected(flows):
    from go_snark_study_tpu_torch.utils import raw
    from go_snark_study_tpu_torch.utils.validate import PointValidationError

    d = raw.groth_proof_to_dict(flows[4])
    d["PiA"][1] = int(d["PiA"][1]) + 1
    with pytest.raises(PointValidationError):
        raw.groth_proof_from_dict(d)


def test_offcurve_g2_rejected(flows):
    from go_snark_study_tpu_torch.utils import raw
    from go_snark_study_tpu_torch.utils.validate import PointValidationError

    d = raw.groth_proof_to_dict(flows[4])
    d["PiB"][0][0] = int(d["PiB"][0][0]) + 1
    with pytest.raises(PointValidationError):
        raw.groth_proof_from_dict(d)


def test_wrong_subgroup_g2_rejected(flows):
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.utils import raw
    from go_snark_study_tpu_torch.utils.validate import PointValidationError, check_g2, check_g2_subgroup

    bad = _twist_point_off_subgroup()
    check_g2(bad)  # on the twist...
    with pytest.raises(PointValidationError):
        check_g2_subgroup(bad)  # ...but not in the r-torsion
    d = raw.groth_proof_to_dict(flows[4])
    d["PiB"] = [[bad[0][0], bad[0][1]], [bad[1][0], bad[1][1]], [1, 0]]
    with pytest.raises(PointValidationError):
        raw.groth_proof_from_dict(d)
    check_g2_subgroup(default_bn128().g2.g)


def test_validation_can_be_disabled(flows, monkeypatch):
    from go_snark_study_tpu_torch.utils import raw

    d = raw.groth_proof_to_dict(flows[4])
    d["PiA"][1] = int(d["PiA"][1]) + 1
    monkeypatch.setenv("GOSNARK_VALIDATE", "0")
    assert raw.groth_proof_from_dict(d).pi_a[1] == d["PiA"][1]
