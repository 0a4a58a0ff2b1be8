"""Layout conversion between the JAX package and the PyTorch port, and the
JAX device key carried over to the port's prover.

The JAX side of the key test is the committed record of
``tests/test_torch_prover.py`` (a live JAX setup costs minutes of XLA
compiles on the CPU); the layout tests run the JAX limb packer live.
"""

import random

import numpy as np
import pytest
import torch

from go_snark_study_tpu.ops.fields import fq_kernels as jax_fq_kernels
from go_snark_study_tpu_torch.bn128 import constants as C
from go_snark_study_tpu_torch.interop import device_pk_from_jax, jax_to_port, port_to_jax
from go_snark_study_tpu_torch.ops.limbs import FieldKernels

from test_torch_prover import (
    CIRCUIT_SEED,
    N_CONSTRAINTS,
    RNG_SEED,
    g1_from,
    g2_from,
    load_golden,
)

# the tier-1 run gives each of its workers a share of the cores; torch's
# own thread pool on top of that oversubscribes them
torch.set_num_threads(1)


def test_layout_roundtrip_matches_jax_packer():
    rng = np.random.default_rng(3)
    vals = [int(x) for x in rng.integers(0, 2**62, 40)]
    vals = [(v << 190) % C.Q for v in vals] + [0, 1, C.Q - 1]
    jax_arr = np.asarray(jax_fq_kernels().pack(vals))
    port = FieldKernels(C.Q, "cpu").pack(vals).numpy()
    np.testing.assert_array_equal(jax_to_port(jax_arr), port)
    np.testing.assert_array_equal(port_to_jax(port), jax_arr)
    # extra trailing axes ride along
    cube = jax_arr[:, :42].reshape(32, 6, 7)
    np.testing.assert_array_equal(port_to_jax(jax_to_port(cube)), cube)


def test_carried_jax_key_proves_like_jax():
    """JAX's DevicePk through device_pk_from_jax, the same rng state as
    JAX's prover: the proof equals JAX's as group elements."""
    from go_snark_study_tpu_torch.bn128 import default_bn128
    from go_snark_study_tpu_torch.models.groth16 import Pk, Vk, verify_proof
    from go_snark_study_tpu_torch.models.groth16_fast import FastGroth16
    from go_snark_study_tpu_torch.synthetic import mul_chain_r1cs

    meta, arrays = load_golden()
    pk = Pk()
    hp = meta["pk"]
    pk.g1.alpha, pk.g1.beta, pk.g1.delta = (g1_from(hp[k]) for k in ("g1_alpha", "g1_beta", "g1_delta"))
    pk.g2.beta, pk.g2.delta = g2_from(hp["g2_beta"]), g2_from(hp["g2_delta"])
    pk._device = device_pk_from_jax(arrays, n=meta["n"], m=meta["m"], lo=meta["lo"], device="cpu")
    assert (pk._device.m_pad, pk._device.mp_pad, pk._device.n_pad) == (128, 128, 128)

    rng = random.Random(RNG_SEED)
    for _ in range(5):  # the setup's five toxic draws precede the prover's r, s
        rng.randrange(C.R)
    r1cs = mul_chain_r1cs(N_CONSTRAINTS, seed=CIRCUIT_SEED)
    proof = FastGroth16(device="cpu").prove(r1cs, pk, rng=rng)

    bn = default_bn128()
    want = meta["proof"]
    assert bn.g1.equal(proof.pi_a, g1_from(want["pi_a"]))
    assert bn.g2.equal(proof.pi_b, g2_from(want["pi_b"]))
    assert bn.g1.equal(proof.pi_c, g1_from(want["pi_c"]))

    vk = Vk(ic=[g1_from(p) for p in meta["vk"]["ic"]])
    vk.g1.alpha = g1_from(meta["vk"]["alpha"])
    vk.g2.beta, vk.g2.gamma, vk.g2.delta = (g2_from(meta["vk"][k]) for k in ("beta", "gamma", "delta"))
    publics = r1cs.witness[1 : r1cs.n_public + 1]
    assert verify_proof(vk, proof, publics)


def test_device_pk_from_jax_rejects_wrong_layout():
    _, arrays = load_golden()
    bad = dict(arrays, at=arrays["at"][:, :8])  # 8-limb rows are the port's layout
    with pytest.raises(AssertionError):
        device_pk_from_jax(bad, n=32, m=33, lo=2, device="cpu")
