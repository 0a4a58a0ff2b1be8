"""The PyTorch port's Groth16 fast path as a whole, held against the JAX
package's ``FastGroth16``.

A live JAX setup + prove costs minutes of XLA compiles on the CPU, so the
JAX side is a committed record: ``go_snark_study_tpu_torch/testdata/
groth16_mul_chain30.npz`` holds what JAX's ``FastGroth16`` gives for
``mul_chain_r1cs(30, seed=1)`` with ``random.Random(42)`` — the vk, the
proof, and the device key.  Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_prover.py --write-golden

The port runs here on the CPU (``device="cpu"``: the kernels' plain
versions); every comparison is group equality.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from go_snark_study_tpu_torch import native

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "go_snark_study_tpu_torch", "testdata", "groth16_mul_chain30.npz",
)
N_CONSTRAINTS, CIRCUIT_SEED, RNG_SEED = 30, 1, 42
KEY_FIELDS = ("at", "b1", "b2", "cdelta", "ptau")


def load_golden():
    z = np.load(GOLDEN)
    meta = json.loads(str(z["meta"]))
    return meta, {k: z[k].astype(np.int32) for k in KEY_FIELDS}


def _g1(p):
    return tuple(int(c) for c in p)


def _g2(p):
    return tuple((int(c[0]), int(c[1])) for c in p)


def jax_record():
    """JAX's FastGroth16 on the recorded inputs, live: (meta, key arrays)."""
    from go_snark_study_tpu.models.groth16_fast import FastGroth16
    from go_snark_study_tpu.synthetic import mul_chain_r1cs

    fast = FastGroth16()
    r1cs = mul_chain_r1cs(N_CONSTRAINTS, seed=CIRCUIT_SEED)
    rng = random.Random(RNG_SEED)
    setup = fast.setup(r1cs, rng=rng)
    proof = fast.prove(r1cs, setup.pk, rng=rng)
    pk, vk, dpk = setup.pk, setup.vk, setup.pk._device
    s = lambda p: [str(c) if isinstance(c, int) else [str(c[0]), str(c[1])] for c in p]
    meta = {
        "n": dpk.n, "m": dpk.m, "lo": dpk.lo,
        "vk": {"alpha": s(vk.g1.alpha), "beta": s(vk.g2.beta), "gamma": s(vk.g2.gamma),
               "delta": s(vk.g2.delta), "ic": [s(p) for p in vk.ic]},
        "pk": {"g1_alpha": s(pk.g1.alpha), "g1_beta": s(pk.g1.beta), "g1_delta": s(pk.g1.delta),
               "g2_beta": s(pk.g2.beta), "g2_delta": s(pk.g2.delta)},
        "proof": {"pi_a": s(proof.pi_a), "pi_b": s(proof.pi_b), "pi_c": s(proof.pi_c)},
    }
    g1 = lambda pt: np.stack([np.asarray(c) for c in pt]).astype(np.uint8)
    g2 = lambda pt: np.stack([np.stack([np.asarray(c) for c in co]) for co in pt]).astype(np.uint8)
    arrays = {k: (g2 if k == "b2" else g1)(getattr(dpk, k)) for k in KEY_FIELDS}
    return meta, arrays


def write_golden():  # pragma: no cover - run by hand, needs JAX
    meta, arrays = jax_record()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, meta=np.array(json.dumps(meta)), **arrays)
    print("wrote", GOLDEN)


def g1_from(meta_pt):
    return _g1(meta_pt)


def g2_from(meta_pt):
    return _g2(meta_pt)


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def port_run():
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    fast = FastGroth16(device="cpu")
    r1cs = mul_chain_r1cs(N_CONSTRAINTS, seed=CIRCUIT_SEED)
    rng = random.Random(RNG_SEED)
    setup = fast.setup(r1cs, rng=rng)
    chains = dict(native.CHAINS)
    proof = fast.prove(r1cs, setup.pk, rng=rng)
    chains = {k: native.CHAINS[k] - chains[k] for k in chains}
    return r1cs, setup, proof, chains


def test_port_setup_matches_jax_vk(golden, port_run):
    from go_snark_study_tpu_torch.bn128 import default_bn128

    meta, _ = golden
    _, setup, _, _ = port_run
    bn = default_bn128()
    vk = meta["vk"]
    assert bn.g1.equal(setup.vk.g1.alpha, g1_from(vk["alpha"]))
    assert bn.g2.equal(setup.vk.g2.beta, g2_from(vk["beta"]))
    assert bn.g2.equal(setup.vk.g2.gamma, g2_from(vk["gamma"]))
    assert bn.g2.equal(setup.vk.g2.delta, g2_from(vk["delta"]))
    assert len(setup.vk.ic) == len(vk["ic"])
    for got, want in zip(setup.vk.ic, vk["ic"]):
        assert bn.g1.equal(got, g1_from(want))


def test_port_device_key_is_jax_device_key(golden, port_run):
    """The affine device key is bit-identical to JAX's after layout
    conversion: the same canonical Montgomery values, lane by lane."""
    from go_snark_study_tpu_torch.interop import port_to_jax

    _, arrays = golden
    _, setup, _, _ = port_run
    dpk = setup.pk._device
    for k in KEY_FIELDS:
        pt = getattr(dpk, k)
        if k == "b2":
            got = np.stack([np.stack([port_to_jax(c) for c in co]) for co in pt])
        else:
            got = np.stack([port_to_jax(c) for c in pt])
        np.testing.assert_array_equal(got, arrays[k], err_msg=k)


def test_port_proof_matches_jax_and_verifies(golden, port_run):
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.models.groth16 import verify_proof

    meta, _ = golden
    r1cs, setup, proof, chains = port_run
    if native._load_pyints():  # the five combinations and six multiplications ran in C
        assert chains == {"native": 11, "python": 0}
    bn = default_bn128()
    want = meta["proof"]
    assert bn.g1.equal(proof.pi_a, g1_from(want["pi_a"]))
    assert bn.g2.equal(proof.pi_b, g2_from(want["pi_b"]))
    assert bn.g1.equal(proof.pi_c, g1_from(want["pi_c"]))
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert verify_proof(setup.vk, proof, publics)
    assert not verify_proof(setup.vk, proof, [publics[0] + 1])


@pytest.mark.slow
def test_golden_record_is_live_jax_output(golden):
    """The committed record is what JAX's FastGroth16 gives today (minutes
    of XLA compiles on the CPU, hence ``slow``)."""
    meta, arrays = golden
    live_meta, live_arrays = jax_record()
    assert json.loads(json.dumps(live_meta)) == meta
    for k in KEY_FIELDS:
        np.testing.assert_array_equal(live_arrays[k].astype(np.int32), arrays[k], err_msg=k)


if __name__ == "__main__":  # pragma: no cover
    if "--write-golden" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        write_golden()
